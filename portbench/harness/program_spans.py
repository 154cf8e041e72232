"""The port's own spans and counters in a run: the span recorder
(`core/spans.py`) and the timing brackets (`runtime/timing.py::stats`).

`run_spans.py` runs a cell as `run.py` does with the recorder on
(`recording`), through what this module adds to the harness, whose files
it leaves as they are:

* `counted(entry)`: each entry's `counters()` with `spans` (the recorder's
  totals) and `timing` (the brackets and their reruns) beside what it
  reads already, read in this process, which runs the server too;
* `SpanDeviceTrace`: the device trace whose idle gaps with no CUDA call at
  their middle are labelled `host in <span>`, the innermost program span
  open there on any thread (the latest start; `summarize`);
* `extra_metrics(cell)`: the per-layer metrics of `program_spans.json`
  that the cell reports, read as `BENCHMARK.json`'s are, and in an
  untraced run too;
* `per_request` and `per_span`: what the readers of those metrics share.

Where the program has no recorder (an older port), `counted` adds nothing
and the readers read nothing.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator
from unittest import mock

from . import runner, spec
from .trace import DEVICE_ACTIVITIES, DeviceTrace, Trace, _activity, _ns
from .trace import summarize as summarize_plain
from .trace import union

METRICS_FILE = spec.BENCH_DIR / "program_spans.json"
NO_CALL = "host code, no CUDA call"


class NoRecorder(RuntimeError):
    """The port has no span recorder."""


def _program():
    """The recorder and the timing module of the port, or None where the
    port has no recorder."""
    try:
        from gpu_image_processing_tpu_torch.core import spans
        from gpu_image_processing_tpu_torch.runtime import timing
    except ImportError:
        return None
    return spans, timing


def counted(entry_cls: type) -> type:
    """`entry_cls` whose `counters()` also give `spans` and `timing`."""

    class Counted(entry_cls):
        def counters(self) -> dict:
            out = super().counters()
            program = _program()
            if program is not None:
                spans, timing = program
                out.update(spans=spans.totals(), timing=timing.stats())
            return out

    Counted.__name__ = f"Counted{entry_cls.__name__}"
    return Counted


def _innermost(spans: list[tuple[int, int, str]], mids: list[int]
               ) -> list[str | None]:
    """For each of the sorted `mids`, the name of the span (start, end,
    name) open there that started last, or None."""
    spans = sorted(spans)
    open_: list[tuple[int, int, str]] = []   # (-start, end, name)
    out: list[str | None] = []
    j = 0
    for mid in mids:
        while j < len(spans) and spans[j][0] <= mid:
            start, end, name = spans[j]
            heapq.heappush(open_, (-start, end, name))
            j += 1
        # A span that ended before this middle ended before every later one.
        while open_ and open_[0][1] < mid:
            heapq.heappop(open_)
        out.append(open_[0][2] if open_ else None)
    return out


def summarize(events: list[tuple[str, str, int, int]], start_ns: int,
              window_ns: int,
              spans: list[tuple[int, int, str]] | None = None) -> Trace:
    """`trace.summarize`, with each idle gap that has no CUDA call at its
    middle labelled `host in <name>` by the innermost program span open
    there (spans as (start ns, end ns, name), the events' clock); a gap
    with neither keeps the plain label.  Without spans, `trace.summarize`
    itself.  The idle time is only divided among labels."""
    plain = summarize_plain(events, start_ns, window_ns)
    if not spans:
        return plain
    end_ns = start_ns + window_ns
    device, host = [], []
    for activity, name, s, e in events:
        s, e = max(s, start_ns), min(e, end_ns)
        if e <= s:
            continue
        if activity in DEVICE_ACTIVITIES:
            device.append((s, e))
        elif activity == "cuda_runtime":
            host.append((s, e, name))
    host.sort()
    busy = union(device)
    edges = [start_ns, *[t for iv in busy for t in iv], end_ns]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) // 2 for a, b in gaps]
    inner = _innermost(spans, mids)
    idle: dict[str, float] = defaultdict(float)
    i = 0
    for (gap_start, gap_end), mid, name in zip(gaps, mids, inner):
        while i < len(host) and host[i][0] <= mid:
            i += 1
        label = next((call for s, e, call in reversed(host[max(0, i - 8):i])
                      if e >= mid), None)
        if label is None:
            label = f"host in {name}" if name else NO_CALL
        idle[label] += (gap_end - gap_start) / 1e9
    return Trace(plain.window_s, plain.busy_s, plain.device_ops, dict(idle))


class SpanDeviceTrace(DeviceTrace):
    """`DeviceTrace` whose idle gaps are labelled by the program's spans
    too (`summarize`)."""

    def __exit__(self, *exc) -> None:
        window_ns = int((time.perf_counter() - self._t0) * 1e9)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        t = time.perf_counter()
        results = self._prof.profiler.kineto_results
        events = [(_activity(e), e.name(), _ns(e, "start"), _ns(e, "end"))
                  for e in results.events()]
        program = _program()
        records = program[0].records() if program else []
        self.result = summarize(
            events, int(results.trace_start_ns()), window_ns,
            [(r.start_ns, r.end_ns, r.name) for r in records])
        print(f"portbench: trace of {len(events)} events and "
              f"{len(records)} spans read in {time.perf_counter() - t:.1f} s",
              flush=True)


def extra_metrics(cell_name: str, path: Path = METRICS_FILE) -> list:
    """(entry, reader) of each metric of `program_spans.json` that cell
    `cell_name` reports."""
    with open(path) as f:
        metrics = json.load(f)["per_layer"]
    return [(m, spec.load_reader("metrics", m["name"]))
            for m in metrics if cell_name in m["workloads"]]


_load = spec.load


def _load_with_extra(cell_name: str, root: Path = spec.ROOT,
                     *overrides) -> spec.Cell:
    """The cell, its metrics of `program_spans.json` read in a traced run
    and in an untraced one too: spans need no device trace, and an
    untraced run shows them without the profiler's own cost."""
    cell = _load(cell_name, root, *overrides)
    extra = extra_metrics(cell_name)
    cell.per_layer = cell.per_layer + extra
    cell.end_to_end = cell.end_to_end + extra
    return cell


@contextlib.contextmanager
def recording() -> Iterator:
    """`runner.run_cell` meanwhile runs with the port's recorder on (from
    before the program starts), the entries
    `counted`, the trace a `SpanDeviceTrace` and the metrics of
    `program_spans.json` read beside the cell's; yields the recorder's
    module.  Raises `NoRecorder` where the port has none."""
    program = _program()
    if program is None:
        raise NoRecorder("the port has no span recorder (core/spans.py)")
    spans = program[0]
    entries = {k: counted(v) for k, v in runner.ENTRIES.items()}
    spans.enable()
    try:
        with mock.patch.object(runner, "ENTRIES", entries), \
                mock.patch.object(runner, "DeviceTrace", SpanDeviceTrace), \
                mock.patch.object(runner.spec, "load", _load_with_extra):
            yield spans
    finally:
        spans.disable()


def span_delta(obs: dict, names: tuple[str, ...], field: str = "ms"
               ) -> float | None:
    """The window's `field` (ms or self_ms) of the spans `names`, summed;
    None where the counters hold no spans."""
    before, after = obs["before"].get("spans"), obs["after"].get("spans")
    if not after:
        return None
    return sum(after.get(n, {}).get(field, 0.0)
               - (before or {}).get(n, {}).get(field, 0.0) for n in names)


def count_delta(obs: dict, name: str) -> int:
    """The window's count of span `name`; 0 where there are no spans."""
    before, after = obs["before"].get("spans"), obs["after"].get("spans")
    if not after:
        return 0
    return (after.get(name, {}).get("count", 0)
            - (before or {}).get(name, {}).get("count", 0))


def per_request(obs: dict, names: tuple[str, ...]) -> float | None:
    """The window's ms of the spans `names` over its requests of the
    route (`phase_ms` `requests`)."""
    total = span_delta(obs, names)
    before, after = obs["before"].get("phase"), obs["after"].get("phase")
    if total is None or not after:
        return None
    n = after.get("requests", 0) - (before or {}).get("requests", 0)
    return total / n if n > 0 else None


def per_span(obs: dict, names: tuple[str, ...], unit: str,
             field: str = "ms", scale: float = 1.0) -> float | None:
    """The window's `field` of the spans `names`, times `scale`, over its
    count of span `unit` (a call, a frame)."""
    total = span_delta(obs, names, field)
    n = count_delta(obs, unit)
    return scale * total / n if total is not None and n > 0 else None
