"""The served call's executable: one captured CUDA graph a key, with its
device buffers and pinned host staging.

The port of the JAX runtime's executable layer
(gpu_image_processing_tpu/runtime/dispatch.py:158-187, 658-777), where each
served call is one compiled executable, built once and cached by its key.
Here it is a `torch.cuda.CUDAGraph` of the served rows function, captured
on a device input buffer of the key's shape:

* a request copies its rows into the pinned input, then to the device
  buffer (not timed); the runtime's timed bracket (runtime/timing.py)
  replays the graph, which launches the same kernels the eager call
  would, on the same bytes; the answer comes back through the pinned
  output, and the caller gets a copy of it, never a view of a buffer the
  next request overwrites;
* the first request of a key builds it, holding the card
  (`timing.exclusive`): the device buffer, then one eager untimed run
  (which builds and loads the kernels); that request copies its rows in
  and out as the eager way does, from pageable memory, and is served by
  eager runs.  The request numbered `CAPTURE_AT`, once the key repeats,
  adds the pinned staging and captures the graph
  (`capture_error_mode="thread_local"`: the threaded server's other
  requests may copy and synchronise meanwhile) and replays it once,
  untimed; it and every later request are served by replays.  Most keys
  the UI sends are seen once (any upload size, a sigma slider), and a
  key seen once pays no capture and pins nothing.  A capture that fails
  raises: from then on a CUDA request of the key is served through the
  graph or fails;
* one lock a key: concurrent first requests build it once, and no two
  requests replay one graph at once;
* the capturing thread counts its wrappers' launches apart
  (`ops.cuda.counted_apart`): the capture launches nothing, and each
  replay adds them to `ops.cuda.LAUNCHES` and their device functions to
  `ops.cuda.ROUTES` (`count_replay`);
* the cache keeps at most `config.EXECUTABLE_CACHE_SIZE` executables,
  least recently used first out: the port has no shape bucketing, so
  every upload size is a key of its own.

The key holds the exact tap table: the level-2 and level-4 gaussian
kernels take their taps by value as launch parameters, so a graph bakes
them in (the JAX key leaves sigma out because its weights are an operand).

On the CPU, which the caller asked for, the same executable serves with
the same buffers, staging, lock, reuse and copy-out, the plain versions
running eagerly: no graph, no pinning.

Spans (core/spans.py): `exec.wait` (for the key's lock), `exec.stage`,
`exec.build` (the untimed first run), `exec.capture` (the capture and its
untimed replay), `exec.fetch` (the answer's allocation, the waits for the
copy out and the host's copy) and `exec.evict`; the cache counts builds
and captures and their ms whether spans are on or off.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Iterator

import numpy as np
import torch

from ..core import spans
from ..ops.cuda import Counted, count_replay, counted_apart
from .timing import exclusive

RowsFn = Callable[[torch.Tensor], torch.Tensor]

#: Bytes of one staging step: the host copies a chunk into pinned memory
#: while the card copies the one before (and the other way for the
#: answer), as the driver pipelines a copy from pageable memory.  The
#: host's copies are torch's, which run on the intra-op threads: numpy's
#: one thread copied a full-size image in about the time of the driver's
#: whole pageable copy (chip_smoke.py phase 7b times one request's steps,
#: and the graph's call with chunks of 1, 2, 4 and 8 MiB and whole).
STAGE_CHUNK = 1 << 23

#: The request of a key that adds its staging and captures its graph (1:
#: the first).  Each executable takes the value when it is made.
CAPTURE_AT = 2


def executable_cache_key(filter_name: str, lvl: int, height: int, width: int,
                         channels: int, radius: int | None,
                         taps: np.ndarray | None,
                         device: torch.device) -> tuple:
    """The key of a single image's executable: filter, served level, batch
    1, H, W, C, radius (None for Sobel, which has none), the f32 bytes of
    the gaussian's tap table (None for the others) and the device."""
    return (filter_name, lvl, 1, height, width, channels,
            None if filter_name == "sobel" else radius,
            None if taps is None else np.asarray(taps, np.float32).tobytes(),
            str(device))


def batch_cache_key(filter_name: str, lvl: int, batch: int, height: int,
                    width: int, channels: int, radius: int | None,
                    taps: np.ndarray | None, device: torch.device) -> tuple:
    """The key of a (B, H, W, C) batch's executable: "batch", then the
    fields of `executable_cache_key` with the batch in its place."""
    single = executable_cache_key(filter_name, lvl, height, width, channels,
                                  radius, taps, device)
    return ("batch", *single[:2], batch, *single[3:])


class FilterExecutable:
    """One served call on rows of one shape: built on its first request,
    staged and its graph captured on request `capture_at`, and replayed
    for every later request of its key."""

    def __init__(self, key: tuple, make_fn: Callable[[], RowsFn],
                 shape: tuple[int, ...], device: torch.device,
                 report: Callable[[str, float], None] | None = None):
        self.key = key
        #: Told ("build", ms) and ("capture", ms) as they happen (the
        #: cache's counters), if given.
        self._report = report
        self.shape = shape
        self.device = device
        self.capture_at = CAPTURE_AT
        self._make_fn = make_fn
        self._lock = threading.Lock()
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._fn: RowsFn | None = None
        self._host_in = self._host_out = self._rows = None
        #: The staging chunks, and on the card an event a chunk of the
        #: answer's copy out.
        self._parts: list[slice] = []
        self._fetched: list[torch.cuda.Event | None] = []
        self._graph: torch.cuda.CUDAGraph | None = None
        self._out: torch.Tensor | None = None
        #: Requests served.
        self.requests = 0
        #: The launches one replay makes, as the capture counted them.
        self.launches: Counted = Counted()
        #: The host's time to enqueue one run, in ms: sizes the card's spin
        #: before a timed run (runtime/timing.py); the untimed first run
        #: sets it, and the untimed replay after the capture, and each
        #: timed run updates it.
        self.enqueue_ms = 0.0
        #: Host ms of the capture.
        self.capture_ms = 0.0
        #: Device bytes the graph's private pool took at capture.
        self.pool_bytes = 0

    @property
    def built(self) -> bool:
        return self._fn is not None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def nbytes(self) -> int:
        """Bytes of one buffer: the key's rows."""
        return int(np.prod(self.shape))

    def pinned_bytes(self) -> int:
        """Pinned host bytes this executable holds (the staging in and
        out), 0 on the CPU."""
        staged = self._cuda and self._host_in is not None
        return 2 * self.nbytes if staged else 0

    def device_bytes(self) -> int:
        """Device bytes this executable holds: the input buffer and the
        graph's pool, 0 on the CPU."""
        return (self.nbytes + self.pool_bytes
                if self._cuda and self._rows is not None else 0)

    def _stream_context(self):
        return (torch.cuda.stream(self._stream) if self._cuda
                else contextlib.nullcontext())

    def _buffers(self, staging: bool) -> None:
        """The device buffer of the key's rows and, with `staging`, the
        host staging in and out (pinned on the card) and its chunks,
        holding the card."""
        with exclusive((self.device,)):
            if self._rows is None:
                self._rows = torch.empty(self.shape, dtype=torch.uint8,
                                         device=self.device)
            if staging and self._host_in is None:
                self._host_in = torch.empty(self.shape, dtype=torch.uint8,
                                            pin_memory=self._cuda)
                self._host_out = torch.empty(self.shape, dtype=torch.uint8,
                                             pin_memory=self._cuda)
                self._parts = [slice(a, min(a + STAGE_CHUNK, self.nbytes))
                               for a in range(0, self.nbytes, STAGE_CHUNK)]
                self._fetched = [torch.cuda.Event() if self._cuda else None
                                 for _ in self._parts]

    def _stage(self, rows: np.ndarray) -> None:
        """The request's rows on to the device buffer on this executable's
        stream: through the staging chunk by chunk, or without it straight
        from `rows` (pageable memory, which the driver stages)."""
        with spans.span("exec.stage"):
            src = torch.from_numpy(np.ascontiguousarray(rows).reshape(-1))
            dev = self._rows.view(-1)
            if self._host_in is None:
                dev.copy_(src)
                return
            pinned = self._host_in.view(-1)
            for part in self._parts:
                pinned[part].copy_(src[part])
                dev[part].copy_(pinned[part], non_blocking=True)

    def _warm_up(self) -> None:
        """The untimed eager run on the staged rows, holding the card: it
        builds and loads the kernels, and times the host's enqueue."""
        with spans.stamped("exec.build") as stamps, exclusive((self.device,)):
            fn = self._make_fn()
            t0 = time.perf_counter()
            fn(self._rows)
            self.enqueue_ms = (time.perf_counter() - t0) * 1000.0
            self._fn = fn
        if self._report is not None:
            self._report("build", stamps.ms)

    def _capture(self) -> None:
        """The function captured on the staged buffer, on this executable's
        stream, then one untimed replay (a graph's first launch uploads
        it, as a build's first run builds the kernels) on the card's
        timing stream, which every later bracket follows, all holding the
        card: no other capture runs, and no bracket shares the card with
        them.  The replay's host time sizes the next timed run's spin.
        `torch.cuda.graph` is not used: it synchronises the card and
        empties the device and pinned caches before each capture."""
        with spans.stamped("exec.capture") as stamps, \
                exclusive((self.device,)):
            with torch.cuda.stream(self._stream):
                t0 = time.perf_counter()
                graph = torch.cuda.CUDAGraph()
                reserved = torch.cuda.memory_reserved(self.device)
                with counted_apart() as launches:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = self._fn(self._rows)
                    finally:
                        graph.capture_end()
            t1 = time.perf_counter()
            self.capture_ms = (t1 - t0) * 1000.0
            self.pool_bytes = (torch.cuda.memory_reserved(self.device)
                               - reserved)
            self.launches = launches
            self._graph, self._out = graph, out
            graph.replay()
            count_replay(launches)
            self.enqueue_ms = (time.perf_counter() - t1) * 1000.0
        if self._report is not None:
            self._report("capture", stamps.ms)

    @contextlib.contextmanager
    def staged(self, rows: np.ndarray) -> Iterator["FilterExecutable"]:
        """Hold this executable for one request with `rows` staged on its
        device; `run` and `fetch` are called inside.  The first request
        builds it (the device buffer, the untimed run) and copies without
        staging; request `capture_at` adds the staging and, on the card,
        captures the graph.  This executable's stream is current
        meanwhile, so a timed bracket (which waits for the current stream)
        follows the copy in."""
        with spans.span("exec.wait"):
            self._lock.acquire()
        with contextlib.ExitStack() as held:
            held.callback(self._lock.release)
            held.enter_context(self._stream_context())
            try:
                repeat = self.requests + 1 >= self.capture_at
                if self._rows is None or (repeat and self._host_in is None):
                    self._buffers(staging=repeat)
                self._stage(rows)
                if not self.built:
                    self._warm_up()
                if repeat and self._cuda and not self.captured:
                    self._capture()
                self.requests += 1
                yield self
            finally:
                if self._cuda:
                    self._stream.synchronize()

    def run(self) -> torch.Tensor:
        """One run on the staged rows: the graph's replay on the current
        stream, its launches counted; before the capture, and on the CPU,
        the function, eagerly."""
        if self._graph is None:
            return self._fn(self._rows)
        self._graph.replay()
        count_replay(self.launches)
        return self._out

    def fetch(self, out: torch.Tensor) -> np.ndarray:
        """A run's output in a new host array of the key's shape: through
        the staging chunk by chunk (the host copies a chunk out while the
        card copies the next ones), or without it in one copy."""
        with spans.span("exec.fetch"):
            answer = torch.empty(self.shape, dtype=torch.uint8)
            if self._host_out is None:
                answer.copy_(out.reshape(self.shape))
                return answer.numpy()
            flat, dst = out.reshape(-1), answer.view(-1)
            pinned = self._host_out.view(-1)
            for part, done in zip(self._parts, self._fetched):
                pinned[part].copy_(flat[part], non_blocking=True)
                if done is not None:
                    done.record(self._stream)
            for part, done in zip(self._parts, self._fetched):
                if done is not None:
                    done.synchronize()
                dst[part].copy_(pinned[part])
            return answer.numpy()


class ExecutableCache:
    """At most `limit` executables by key, least recently used first out.
    An evicted executable is dropped once no request holds it: its graph,
    its pool and its buffers go with it."""

    def __init__(self, limit: int):
        self.limit = limit
        self._lock = threading.Lock()
        self._items: OrderedDict[tuple, FilterExecutable] = OrderedDict()
        #: Executables dropped to keep the limit, since the cache was made.
        self.evictions = 0
        #: Requests, and those that found their key held, since the cache
        #: was made.
        self.requests = 0
        self.hits = 0
        #: Builds (a key's untimed first run) and captures (the graph and
        #: its untimed replay) of its executables and their host ms, since
        #: the cache was made: an evicted key's are kept.
        self.built = {"builds": 0, "build_ms": 0.0, "captures": 0,
                      "capture_ms": 0.0}

    def record(self, kind: str, ms: float) -> None:
        """One "build" or "capture" of an executable, of `ms` host ms."""
        with self._lock:
            self.built[f"{kind}s"] += 1
            self.built[f"{kind}_ms"] += ms

    def get(self, key: tuple, make: Callable[[], FilterExecutable]
            ) -> FilterExecutable:
        """The executable of `key` for one request, made (not built) if it
        is not held."""
        with self._lock:
            self.requests += 1
            exe = self._items.get(key)
            if exe is None:
                exe = self._items[key] = make()
                while len(self._items) > self.limit:
                    with spans.span("exec.evict"):
                        self._items.popitem(last=False)
                    self.evictions += 1
            else:
                self.hits += 1
                self._items.move_to_end(key)
            return exe

    def __iter__(self) -> Iterator[tuple]:
        with self._lock:
            return iter(list(self._items))

    def __len__(self) -> int:
        return len(self._items)

    def values(self) -> list[FilterExecutable]:
        with self._lock:
            return list(self._items.values())

    def stats(self) -> dict:
        """What the cache holds and how it served: executables, graphs
        captured, evictions, requests and those that found their key
        held, their pinned and device bytes, and on the card the process's
        pinned bytes (`torch.cuda.host_memory_stats`: the caching host
        allocator's blocks, in use and cached, each rounded up to a power
        of two) and the card's reserved bytes."""
        exes = self.values()
        with self._lock:
            built = dict(self.built)
        out = {"executables": len(exes),
               "captured": sum(e.captured for e in exes), "limit": self.limit,
               "evictions": self.evictions, "requests": self.requests,
               "hits": self.hits, **built,
               "pinned_bytes": sum(e.pinned_bytes() for e in exes),
               "device_bytes": sum(e.device_bytes() for e in exes)}
        devices = {e.device for e in exes if e.device.type == "cuda"}
        if devices:
            host = torch.cuda.host_memory_stats()
            out["process_pinned_bytes"] = host.get("allocated_bytes.current")
            out["card_reserved_bytes"] = sum(
                torch.cuda.memory_reserved(d) for d in devices)
        return out
