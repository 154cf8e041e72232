"""Kernel timing with the reference's discipline: only the filter's device
work is timed (image_filters.cu:804-894).

On a CUDA device, CUDA events on the current stream bracket the launches,
and the card's queue is filled first: a spin kernel (`torch.cuda._sleep`)
runs while the host enqueues the filter, so the start event is reached only
once every launch of the filter waits behind it, and the events time the
card's work, not the host's work in and between the wrappers (tens of
microseconds a launch, as long as the kernels themselves).  The spin is
sized from the host's own enqueue time for the call (`spin_cycles`), which
the caller measures on its untimed first run and which every timed run
updates.  If the start event has completed by the time the filter returns
on the host, the card went idle inside the bracket: that reading is not
kept, and the run goes again with a longer spin (up to `MAX_SPIN_MS`, where
the reading is kept as it is).  Host-to-device and device-to-host copies
happen outside.  On the CPU the bracket is wall time.  The devices of a
mesh are timed alike: each card's queue is filled and bracketed, and the
longest bracket counts (on one card, one bracket around every shard's
launches and the halo copies).  The caller runs the work once untimed
first, so a kernel's first call (which builds it) is never timed.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import torch

#: The spin lasts SPIN_FACTOR times the host's enqueue time plus SPIN_PAD_MS.
SPIN_FACTOR = 2.0
SPIN_PAD_MS = 0.05
#: The longest spin: a first run that built a kernel measures the build.
MAX_SPIN_MS = 200.0
#: The spin counts SM clock cycles; at the H100's highest SM clock, so it
#: lasts at least as long at any lower clock.
SPIN_CLOCK_HZ = 1.98e9


def spin_ms(enqueue_ms: float) -> float:
    """The spin, in ms, that outlasts a host enqueue of `enqueue_ms`."""
    return min(SPIN_FACTOR * max(enqueue_ms, 0.0) + SPIN_PAD_MS, MAX_SPIN_MS)


def spin_cycles(ms: float) -> int:
    """SM clock cycles of a spin of `ms` at `SPIN_CLOCK_HZ`."""
    return int(ms * 1e-3 * SPIN_CLOCK_HZ)


def _timed_on_cards(fn: Callable[[], Any], devices: Sequence[torch.device],
                    enqueue_ms: float) -> tuple[Any, float, float]:
    """(result, card ms, host enqueue ms) of one run of `fn` behind a spin
    on each card; the card ms is the longest of the cards' brackets."""
    streams = [torch.cuda.current_stream(d) for d in devices]
    spin = spin_ms(enqueue_ms)
    while True:
        starts = [torch.cuda.Event(enable_timing=True) for _ in devices]
        ends = [torch.cuda.Event(enable_timing=True) for _ in devices]
        for device, stream, start in zip(devices, streams, starts):
            with torch.cuda.device(device):
                torch.cuda._sleep(spin_cycles(spin))
            start.record(stream)
        t0 = time.perf_counter()
        out = fn()
        host_ms = (time.perf_counter() - t0) * 1000.0
        # A spin that ended before the host was done left its card idle.
        idle = any(start.query() for start in starts)
        for stream, end in zip(streams, ends):
            end.record(stream)
        for end in ends:
            end.synchronize()
        if not idle or spin >= MAX_SPIN_MS:
            return out, max(s.elapsed_time(e) for s, e in zip(starts, ends)), host_ms
        spin = max(2.0 * spin, spin_ms(host_ms))


def timed(fn: Callable[[], Any],
          device: torch.device | Sequence[torch.device], reps: int,
          enqueue_ms: float = 0.0) -> tuple[Any, float, float]:
    """Run `fn` `reps` times; return its last result, the least time in ms
    and the least host time of a run in ms.  `enqueue_ms`: the host's time
    to run `fn` measured before, which sizes the card's spin.

    `device` is the device `fn` runs on, or the devices of a mesh (each
    named once or more): each card's queue is filled, each card brackets
    the run with its own events, and the longest bracket is the time.
    """
    devices = ([device] if isinstance(device, torch.device)
               else list(dict.fromkeys(device)))
    best = host_best = float("inf")
    out = None
    for _ in range(max(1, reps)):
        if devices[0].type == "cuda":
            out, ms, host_ms = _timed_on_cards(fn, devices, enqueue_ms)
            enqueue_ms = host_ms
        else:
            t0 = time.perf_counter()
            out = fn()
            ms = host_ms = (time.perf_counter() - t0) * 1000.0
        best = min(best, ms)
        host_best = min(host_best, host_ms)
    return out, best, host_best
