"""Layer: Runtime (served).  The server's run phase of the route, ms a
request over the window's requests (`/api/stats` `phase_ms`, read before
and after the window; host clock).  Moves `request_p90_ms`."""

from portbench.harness.stats import delta


def read(obs: dict) -> float | None:
    before, after = obs["before"].get("phase"), obs["after"].get("phase")
    if not after:
        return None
    n = delta(after, before, "requests")
    return delta(after, before, "run") / n if n > 0 else None
