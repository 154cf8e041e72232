"""Images filtered a second through the API: every call completed inside
the window, one image each, over its length (host clock, one caller in a
closed loop)."""

from portbench.harness.stats import window_rate as read  # noqa: F401
