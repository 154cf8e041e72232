"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

`LAUNCHES` counts, per kernel, the calls of its wrapper that launched the
kernel (never a call served by the plain version), so a run can show which
kernels its main path went through.  `ROUTES` counts the blur launches again
by the device function each ran, keyed "<wrapper>: <function>" (for example
"box_rows: box_window_rows" or "gaussian_rows: gauss_window_rows<Weighted,
0>", the radius at run time), as `blur.cu`'s `gip_blur_route` names it from
the rules that pick the function.  The wrappers count through
`count_launch`: a thread that captures a CUDA graph counts its own calls
apart (`counted_apart`), since the capture launches nothing and each replay
of the graph counts them again (`count_replay`); every other thread counts
into `LAUNCHES` and `ROUTES` meanwhile.  Each wrapper's host work and its
ctypes launch is the span `ops.launch` (core/spans.py).  The wrappers
launch through plans (`plan.py`), bound once per launch function, radius,
channels and card; `LAUNCH_PLANS` counts the plans `built`, the launches
a plan already `held` served, and the tap arrays `taps_rebuilt` for a
gaussian table that changed (never counted apart: a capture does that host
work, a replay does not).
"""

import contextlib
import threading
from collections import Counter
from typing import Iterator

LAUNCHES: Counter = Counter()
ROUTES: Counter = Counter()
LAUNCH_PLANS: Counter = Counter()



class _Apart(threading.local):
    """The calling thread's `Counted` while it captures, else None."""

    counter: "Counted | None" = None


_APART = _Apart()


class Counted(Counter):
    """Launches by kernel, and in `routes` the device functions they ran."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.routes: Counter = Counter()


def count_launch(name: str, route: str | None = None) -> None:
    """One launch of `name`'s kernel by the calling thread's wrapper, which
    ran the device function `route` (blur launches)."""
    count_keyed(name, None if route is None else f"{name}: {route}")


def count_keyed(name: str, route_key: str | None) -> None:
    """`count_launch` with the `ROUTES` key already formatted."""
    counted = _APART.counter
    if counted is None:
        LAUNCHES[name] += 1
        if route_key is not None:
            ROUTES[route_key] += 1
    else:
        counted[name] += 1
        if route_key is not None:
            counted.routes[route_key] += 1


def count_replay(counted: Counted) -> None:
    """Count again the launches and routes `counted` holds: one replay of
    the graph whose capture counted them."""
    LAUNCHES.update(counted)
    ROUTES.update(counted.routes)


@contextlib.contextmanager
def counted_apart() -> Iterator[Counted]:
    """The calling thread's launches, meanwhile, in the `Counted` yielded
    instead of `LAUNCHES` and `ROUTES`."""
    counter = Counted()
    _APART.counter = counter
    try:
        yield counter
    finally:
        _APART.counter = None
