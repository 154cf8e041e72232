"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

`LAUNCHES` counts, per kernel, the calls of its wrapper that launched the
kernel (never a call served by the plain version), so a run can show which
kernels its main path went through.
"""

from collections import Counter

LAUNCHES: Counter = Counter()
