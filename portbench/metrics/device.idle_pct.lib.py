"""Layer: Device.  The share of the traced window in which nothing ran on
the card (no kernel, copy or set), in the API caller's process
(`torch.profiler`, CUDA activity).  Moves `images_per_s`."""

from portbench.harness.stats import idle_pct as read  # noqa: F401
