"""Layer: Codec.  The server's decode and encode phases of the route, ms a
request over the window's requests (`/api/stats` `phase_ms`, read before
and after the window; host clock).  Moves `requests_per_s`."""

from portbench.harness.stats import delta


def read(obs: dict) -> float | None:
    before, after = obs["before"].get("phase"), obs["after"].get("phase")
    if not after:
        return None
    n = delta(after, before, "requests")
    if n <= 0:
        return None
    return (delta(after, before, "decode") + delta(after, before, "encode")) / n
