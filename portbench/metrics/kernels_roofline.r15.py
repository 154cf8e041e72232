"""Layer: Kernels.  `kernels_roofline` in the r = 15 cell: the least time
the window's calls needed, counted by filter function, shape and radius
(`reference/work.py`), over the card's busy time in the traced window.
Keyed by the work and never by a kernel's name, so a kernel replaced on
the cell's path is read against the same work.  Moves `frames_per_s`."""

from portbench.harness import spec

read = spec.load_reader("metrics", "kernels_roofline").read
