"""Layer: Executables.  The share of the window's calls that found their
key's executable held (`FilterRuntime.executables.stats()` `hits` over
`requests`, deltas over the window; a program counter).  Moves
`images_per_s`."""

from portbench.harness.stats import delta


def read(obs: dict) -> float | None:
    before = obs["before"].get("executables")
    after = obs["after"].get("executables")
    if not after:
        return None
    n = delta(after, before, "requests")
    return 100.0 * delta(after, before, "hits") / n if n > 0 else None
