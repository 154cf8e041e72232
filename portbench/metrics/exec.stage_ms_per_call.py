"""Layer: Executables.  Copying a call's rows into pinned staging and
enqueueing them to the card, ms a call over the window's calls: the span
`exec.stage` over the spans `runtime.call`, from the port's span
recorder.  Moves `images_per_s`."""

from portbench.harness.program_spans import per_span


def read(obs: dict) -> float | None:
    return per_span(obs, ("exec.stage",), "runtime.call")
