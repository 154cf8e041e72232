"""Arithmetic that the readers share: rates, percentiles, deltas, the
idle share.  A window's calls are (sent, done, ok) each, host clock."""

from __future__ import annotations

import statistics


def percentile(values: list[float], q: int) -> float:
    """The q-th percentile, linear between order statistics (Python's
    `statistics.quantiles`, inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def completed_rate(calls, t0: float, t1: float) -> float:
    """Calls a second that completed, and succeeded, inside [t0, t1]."""
    return sum(1 for sent, done, ok in calls
               if ok and t0 <= done <= t1) / (t1 - t0)


def latencies_ms(calls, t0: float, t1: float) -> list[float]:
    """Send to reply, ms, of every call sent inside [t0, t1), failed ones
    included."""
    return [(done - sent) * 1000.0 for sent, done, _ in calls
            if t0 <= sent < t1]


def delta(after: dict, before: dict, key: str) -> float:
    return float(after.get(key, 0)) - float(before.get(key, 0))


def window_rate(obs: dict) -> float | None:
    """A reader: the window's completed calls a second (each call one
    image, frame or request)."""
    return completed_rate(obs["calls"], obs["t0"], obs["t1"])


def idle_pct(obs: dict) -> float | None:
    """A reader: the share of the traced window in which nothing ran on
    the card, in the process that drives it."""
    return obs["trace"].idle_pct if obs.get("trace") else None
