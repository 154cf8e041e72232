"""The device trace of a measured window: `torch.profiler` with CUDA
activity only, in the process that drives the card.

From it come the device's busy time (the union of every kernel, copy and
set on the card), the traced window's length, the kernels by device time
and the idle gaps by what the host was doing (the CUDA runtime call that
covers a gap's middle, else host code with no CUDA call).  A trace whose
events carry no device time raises: a cell's traced run drives the card.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: Device time by kernel or copy name, seconds.
    device_ops: dict[str, float] = field(default_factory=dict)
    #: Idle device time by what the host was doing, seconds.
    idle_by_host: dict[str, float] = field(default_factory=dict)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> dict:
        def largest(d: dict[str, float]) -> list:
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]
        return {"device_ops": largest(self.device_ops),
                "idle_gaps": largest(self.idle_by_host)}


def _ns(event, which: str) -> int:
    return int(getattr(event, f"{which}_ns")())


def _activity(event) -> str:
    """The event's kind: its activity type where this torch gives it, else
    "kernel" for anything on the card and "cuda_runtime" for a CUDA call
    of the host (runtime `cuda*` or driver `cu*`)."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return str(kind()).lower()
    if "CUDA" in str(event.device_type()):
        return "kernel"
    return "cuda_runtime" if event.name().startswith("cu") else "cpu_op"


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sorted, merged intervals."""
    merged: list[list[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def summarize(events: list[tuple[str, str, int, int]], start_ns: int,
              window_ns: int) -> Trace:
    """A `Trace` of (activity, name, start ns, end ns) events in the window
    [start_ns, start_ns + window_ns]."""
    end_ns = start_ns + window_ns
    device, host = [], []
    ops: dict[str, float] = defaultdict(float)
    for activity, name, s, e in events:
        s, e = max(s, start_ns), min(e, end_ns)
        if e <= s:
            continue
        if activity in DEVICE_ACTIVITIES:
            device.append((s, e))
            ops[name[:NAME_CHARS]] += (e - s) / 1e9
        elif activity == "cuda_runtime":
            host.append((s, e, name))
    busy = union(device)
    if not busy:
        raise RuntimeError("the trace holds no device time: the window drove "
                           "nothing on the card, or the profiler saw none of "
                           "it")
    host.sort()
    idle: dict[str, float] = defaultdict(float)
    edges = [start_ns, *[t for iv in busy for t in iv], end_ns]
    i = 0
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end <= gap_start:
            continue
        mid = (gap_start + gap_end) // 2
        while i < len(host) and host[i][0] <= mid:
            i += 1
        # The covering call began before the middle: among the last few,
        # since calls on several host threads may overlap.
        label = next((name for s, e, name in reversed(host[max(0, i - 8):i])
                      if e >= mid), "host code, no CUDA call")
        idle[label] += (gap_end - gap_start) / 1e9
    return Trace(window_ns / 1e9, sum(e - s for s, e in busy) / 1e9,
                 dict(ops), dict(idle))


class DeviceTrace:
    """A context that traces the card while it is open; `result` holds the
    `Trace` once it has closed."""

    def __init__(self) -> None:
        self.result: Trace | None = None

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        window_ns = int((time.perf_counter() - self._t0) * 1e9)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        t = time.perf_counter()
        results = self._prof.profiler.kineto_results
        events = [(_activity(e), e.name(), _ns(e, "start"), _ns(e, "end"))
                  for e in results.events()]
        self.result = summarize(events, int(results.trace_start_ns()),
                                window_ns)
        print(f"portbench: trace of {len(events)} events read in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
