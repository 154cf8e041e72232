"""Layer: Models.  The modules' own host time, us a frame: the self time
of the span `models.forward` (its time less the kernels' `ops.launch`
inside) over the window's forwards, from the port's span recorder.
Moves `frames_per_s`."""

from portbench.harness.program_spans import per_span


def read(obs: dict) -> float | None:
    return per_span(obs, ("models.forward",), "models.forward", "self_ms",
                    1000.0)
