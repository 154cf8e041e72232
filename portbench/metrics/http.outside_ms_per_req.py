"""Layer: HTTP.  The clients' wall summed over the window's requests less
the server's phases summed over the same requests, ms a request: the
JSON, base64, socket and queue time outside decode, run, encode and
profile.  Moves `request_p90_ms`."""

from portbench.harness.stats import delta

PHASES = ("decode", "run", "encode", "profile")


def read(obs: dict) -> float | None:
    before, after = obs["before"].get("phase"), obs["after"].get("phase")
    if not after:
        return None
    n = delta(after, before, "requests")
    calls = [c for c in obs["calls"] if obs["t0"] <= c[0] < obs["t1"]]
    if n <= 0 or n != len(calls) or not all(ok for _, _, ok in calls):
        return None
    wall = sum(done - sent for sent, done, _ in calls) * 1000.0
    return (wall - sum(delta(after, before, p) for p in PHASES)) / n
