"""Layer: Executables.  Fetching a call's answer: its allocation, the
waits for the card's copy out and the host's copy, ms a call over the
window's calls: the span `exec.fetch` over the spans `runtime.call`,
from the port's span recorder.  Moves `images_per_s`."""

from portbench.harness.program_spans import per_span


def read(obs: dict) -> float | None:
    return per_span(obs, ("exec.fetch",), "runtime.call")
