"""Kernel timing with the reference's discipline: only the filter's device
work is timed (image_filters.cu:804-894).

On a CUDA device, CUDA events on the current stream bracket the launches;
host-to-device and device-to-host copies happen outside.  On the CPU the
same bracket is wall time.  The caller runs the work once untimed first,
so a kernel's first call (which builds it) is never timed.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def timed(fn: Callable[[], torch.Tensor], device: torch.device,
          reps: int) -> tuple[torch.Tensor, float]:
    """Run `fn` `reps` times; return its last result and the least time in ms."""
    best = float("inf")
    out = None
    for _ in range(max(1, reps)):
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn()
            end.record(stream)
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1000.0
        best = min(best, ms)
    return out, best
