"""Layer: Runtime.  A call's timed runs: the spin, `TIMING_REPS` runs, the
events and any rerun, ms a call over the window's calls: the span
`runtime.bracket` over the spans `runtime.call`, from the port's span
recorder.  Moves `images_per_s`."""

from portbench.harness.program_spans import per_span


def read(obs: dict) -> float | None:
    return per_span(obs, ("runtime.bracket",), "runtime.call")
