"""Layer: Kernels.  The kernel wrappers' host work and the ctypes launch,
us a frame: the span `ops.launch` over the window's `models.forward`,
from the port's span recorder.  Moves `frames_per_s`."""

from portbench.harness.program_spans import per_span


def read(obs: dict) -> float | None:
    return per_span(obs, ("ops.launch",), "models.forward", "ms", 1000.0)
