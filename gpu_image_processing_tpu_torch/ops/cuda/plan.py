"""Launch plans: what a kernel wrapper's launch needs that no call changes,
bound once per (launch function, radius, channels, card).

A wrapper asks `get` for its key's plan on every launch.  The first launch
of a key builds it, under a lock, so that threads launching a new key at
once build it once: the library loaded (`build.load`: the card's check,
every function's ctypes types), the ctypes function, its `LAUNCHES` name
and, for a blur, its `ROUTES` key formatted (`blur.route` asks `blur.cu`
once per key).  Later launches read it without a lock.  No key holds the
image's size, so images of every size and batch share their key's plan.

Per call a launch still checks its rows, reads their shape, allocates its
output, reads PyTorch's current stream on the plan's card (a graph capture
runs on a stream of its own), switches the current device only where it is
not the plan's, and hands a gaussian's taps over by value: `Plan.host_taps`
compares the table's bytes with those of the last tap array the plan made,
reuses that array where they are equal and makes a new one where they
differ, so a table changed between two calls is honoured.

`LAUNCH_PLANS` (`ops.cuda`; `/api/stats` `launch_plans`) counts the plans
`built`, the launches a plan `held` already served, and the tap arrays
`taps_rebuilt` for a table other than the plan's last.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Hashable

import torch

from . import LAUNCH_PLANS, build, count_keyed

_PLANS: dict[Hashable, "Plan"] = {}
_LOCK = threading.Lock()


def _current_device() -> int:
    """The calling thread's current CUDA device."""
    return torch._C._cuda_getDevice()


def _current_stream(device: int) -> int:
    """PyTorch's current stream on `device`, as the integer the C side
    takes."""
    return torch._C._cuda_getCurrentRawStream(device)


class Plan:
    """One launch function of a kernel library, bound to a card: its
    ctypes function, `LAUNCHES` name and `ROUTES` key, and the tap array of
    the last table it launched."""

    __slots__ = ("lib", "fn", "fn_name", "name", "route_key", "device",
                 "taps")

    def __init__(self, lib: ctypes.CDLL, fn_name: str, name: str,
                 route: str | None, device: int):
        self.lib = lib
        self.fn = getattr(lib, fn_name)
        self.fn_name = fn_name
        self.name = name
        self.route_key = None if route is None else f"{name}: {route}"
        self.device = device
        #: (table bytes, ctypes array) of the last table, or None.
        self.taps: tuple[bytes, ctypes.Array] | None = None

    def host_taps(self, table: torch.Tensor) -> ctypes.Array:
        """A contiguous (2r+1,) float32 table as the host array the
        gaussian kernels copy into their launch parameters (a table on the
        card is read back, which waits for the card)."""
        if not table.is_cpu:
            table = table.cpu()
        data = ctypes.string_at(table.data_ptr(), table.nbytes)
        held = self.taps
        if held is not None and held[0] == data:
            return held[1]
        if held is not None:
            LAUNCH_PLANS["taps_rebuilt"] += 1
        array = (ctypes.c_float * (len(data) // 4)).from_buffer_copy(data)
        self.taps = (data, array)
        return array

    def launch(self, *args) -> None:
        """Call the launch function with `args` and the current stream on
        the plan's card, raise if it returned a CUDA error, and count the
        launch."""
        device = self.device
        if _current_device() == device:
            code = self.fn(*args, _current_stream(device))
        else:
            with torch.cuda.device(device):
                code = self.fn(*args, _current_stream(device))
        if code:
            build.check(self.lib, code, self.fn_name)
        count_keyed(self.name, self.route_key)


def get(key: Hashable, make: Callable[..., Plan], *args) -> Plan:
    """The plan of `key`, made by `make(*args)` on the key's first
    launch."""
    plan = _PLANS.get(key)
    if plan is None:
        with _LOCK:
            plan = _PLANS.get(key)
            if plan is None:
                plan = _PLANS[key] = make(*args)
                LAUNCH_PLANS["built"] += 1
                return plan
    LAUNCH_PLANS["held"] += 1
    return plan
