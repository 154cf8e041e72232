"""Spans of the port's host work: named intervals on the host clock, one
recorder for the process, off by default.

    from gpu_image_processing_tpu_torch.core import spans

    spans.enable()                  # or the server's --spans
    with spans.span("exec.stage"):
        ...
    spans.totals()    # {name: {"count", "ms", "self_ms"}}
    spans.records()   # completed spans, Unix-epoch ns

Off, `span(name)` returns one shared object that does nothing: a span
costs one global read, no clock read and no allocation.  On, a span stamps
`time.perf_counter_ns()` as it opens and as it closes, and records its
name, its thread, its parent (the innermost span open on that thread when
it opened) and its request id (`request`: every span of one request shares
it).  `totals()` keeps every completed span's count, time and self time
(its time less its children's) by name; the spans themselves go into a
buffer of `capacity`, and those past it are counted in `dropped`.  Nothing
is written to a file.

`records()` gives the spans in Unix-epoch nanoseconds, the clock of
`torch.profiler`'s (Kineto's) events, through one (`time.time_ns()`,
`time.perf_counter_ns()`) pair taken at `enable()`, so a span can be laid
on a device trace.

Threads: the threaded server runs one thread a connection; each thread has
its own open spans and request id, and the recorder's totals and buffer
take a lock.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

#: Spans a recorder keeps unless `enable` is told otherwise.
DEFAULT_CAPACITY = 1 << 20


class Record(NamedTuple):
    """One completed span; times in Unix-epoch ns."""

    name: str
    thread: int
    parent: str | None
    request: int | None
    start_ns: int
    end_ns: int


class _Recorder:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.lock = threading.Lock()
        self.local = threading.local()
        #: name -> [count, ns, self ns]
        self.totals: dict[str, list[int]] = {}
        #: (name, thread, parent, request, start, end), perf_counter ns;
        #: made whole here, so that recording allocates no list memory.
        self.buffer: list[tuple | None] = [None] * capacity
        self.kept = 0
        self.dropped = 0
        self.requests = itertools.count(1)
        self.anchor_epoch_ns = time.time_ns()
        self.anchor_perf_ns = time.perf_counter_ns()

    def stack(self) -> list["_Span"]:
        """The calling thread's open spans (its request id beside them)."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            self.local.request = None
            return self.local.stack


class _Off:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()
_recorder: _Recorder | None = None


class _Span:
    """One span as it is open.  Without a recorder it only stamps: its
    `ms` is there for a caller that keeps its own total (the server's
    `phase_ms`, the executables' build and capture ms)."""

    __slots__ = ("name", "rec", "start", "end", "children", "parent",
                 "request", "opens", "stack")

    def __init__(self, name: str, rec: _Recorder | None,
                 opens: bool = False):
        self.name, self.rec, self.opens = name, rec, opens
        self.children = 0

    def __enter__(self) -> "_Span":
        rec = self.rec
        if rec is not None:
            stack = self.stack = rec.stack()
            self.parent = stack[-1].name if stack else None
            local = rec.local
            if self.opens and local.request is None:
                local.request = next(rec.requests)
            else:
                self.opens = False
            self.request = local.request
            stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = self.end = time.perf_counter_ns()
        rec = self.rec
        if rec is None:
            return
        stack = self.stack
        stack.pop()
        ns = end - self.start
        if stack:
            stack[-1].children += ns
        if self.opens:
            rec.local.request = None
        with rec.lock:
            entry = rec.totals.get(self.name)
            if entry is None:
                entry = rec.totals[self.name] = [0, 0, 0]
            entry[0] += 1
            entry[1] += ns
            entry[2] += ns - self.children
            if rec.kept < rec.capacity:
                rec.buffer[rec.kept] = (self.name, threading.get_ident(),
                                        self.parent, self.request,
                                        self.start, end)
                rec.kept += 1
            else:
                rec.dropped += 1

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6


def span(name: str) -> _Span | _Off:
    """A context that records one span of `name` while the recorder is
    on, and does nothing while it is off."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(name, rec)


def request(name: str) -> _Span | _Off:
    """`span(name)` that also opens a request on its thread, unless one is
    open there: every span of the thread until it closes has its id."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(name, rec, opens=True)


def stamped(name: str) -> _Span:
    """`span(name)` whose stamps are taken on or off; its `ms` once it has
    closed."""
    return _Span(name, _recorder)


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Turn the recorder on, empty, keeping at most `capacity` spans (the
    totals count every span).  Spans open meanwhile are not recorded."""
    global _recorder
    _recorder = _Recorder(capacity)


def disable() -> None:
    """Turn the recorder off; what it held goes."""
    global _recorder
    _recorder = None


def totals() -> dict[str, dict[str, float]]:
    """Per span name: count, total ms and self ms of the completed spans;
    {} while off."""
    rec = _recorder
    if rec is None:
        return {}
    with rec.lock:
        items = [(k, list(v)) for k, v in rec.totals.items()]
    return {k: {"count": n, "ms": ns / 1e6, "self_ms": own / 1e6}
            for k, (n, ns, own) in items}


def dropped() -> int:
    """Spans past the capacity, counted in the totals and not kept."""
    rec = _recorder
    return rec.dropped if rec is not None else 0


def records() -> list[Record]:
    """The kept spans, in the order they closed, on the Unix-epoch clock
    of `time.time_ns()`; [] while off."""
    rec = _recorder
    if rec is None:
        return []
    with rec.lock:
        kept = rec.buffer[:rec.kept]
    shift = rec.anchor_epoch_ns - rec.anchor_perf_ns
    return [Record(name, thread, parent, req, start + shift, end + shift)
            for name, thread, parent, req, start, end in kept]
