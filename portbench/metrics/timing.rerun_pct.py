"""Layer: Runtime.  The share of the window's timed runs done again
because the card idled inside the bracket (`runtime/timing.py::stats`
`reruns` over `brackets`, deltas over the window; a program counter).
Moves `images_per_s`."""

from portbench.harness.stats import delta


def read(obs: dict) -> float | None:
    before, after = obs["before"].get("timing"), obs["after"].get("timing")
    if not after:
        return None
    n = delta(after, before or {}, "brackets")
    return 100.0 * delta(after, before or {}, "reruns") / n if n > 0 else None
