"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

`LAUNCHES` counts, per kernel, the calls of its wrapper that launched the
kernel (never a call served by the plain version), so a run can show which
kernels its main path went through.  The wrappers count through
`count_launch`: a thread that captures a CUDA graph counts its own calls
apart (`counted_apart`), since the capture launches nothing and each replay
of the graph counts them; every other thread counts into `LAUNCHES`
meanwhile.  Each wrapper's host work and its ctypes launch is the span
`ops.launch` (core/spans.py).
"""

import contextlib
import threading
from collections import Counter
from typing import Iterator

LAUNCHES: Counter = Counter()

_APART = threading.local()


def count_launch(name: str) -> None:
    """One launch of `name`'s kernel by the calling thread's wrapper."""
    counter = getattr(_APART, "counter", None)
    (LAUNCHES if counter is None else counter)[name] += 1


@contextlib.contextmanager
def counted_apart() -> Iterator[Counter]:
    """The calling thread's launches, meanwhile, in the Counter yielded
    instead of `LAUNCHES`."""
    counter: Counter = Counter()
    _APART.counter = counter
    try:
        yield counter
    finally:
        _APART.counter = None
