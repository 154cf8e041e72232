"""The 90th percentile of every request sent in the window, client clock,
from the send to the last byte of the reply.  p90 and not p95: one client
completes a few tens of requests a window, and p90 keeps some beyond
it."""

from portbench.harness.stats import latencies_ms, percentile


def read(obs: dict) -> float | None:
    lat = latencies_ms(obs["calls"], obs["t0"], obs["t1"])
    return percentile(lat, 90) if lat else None
