"""Frames filtered a second through the modules' forward: every call
completed inside the window, one frame on the card each and ending in a
synchronize, over its length (host clock, one caller in a closed
loop)."""

from portbench.harness.stats import window_rate as read  # noqa: F401
