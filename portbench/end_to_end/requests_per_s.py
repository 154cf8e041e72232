"""Completed UI requests a second: the requests that received a 200 reply
inside the window, over its length (host clock, closed loop)."""

from portbench.harness.stats import window_rate as read  # noqa: F401
