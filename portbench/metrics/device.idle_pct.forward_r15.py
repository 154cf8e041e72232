"""Layer: Device.  The share of the traced window in which nothing ran on
the card (no kernel, copy or set), in the process that calls the modules'
forward at r = 15 (`torch.profiler`, CUDA activity).  Moves
`frames_per_s`."""

from portbench.harness.stats import idle_pct as read  # noqa: F401
