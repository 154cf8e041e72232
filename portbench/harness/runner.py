"""One run of one cell: set up, measure a window, check, report.

The order is the contract's: the libraries are built (a checkout's first
run only, its seconds printed apart), the program starts and the cell's
shapes are warmed, all of it `setup_s`; the window runs for `seconds`,
traced or not; then the card's peak memory is read, the program's state
is freed, the sample is held against the reference and the metrics are
read.  Last, right before the result is made, the loaded modules are
checked.  The last line of standard output is the result.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

from . import chip, spec
from .check import Comparison
from .entries import ENTRIES, Context
from .trace import DeviceTrace


def _err(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def build_libraries() -> float:
    """Build what the port has not built in this checkout; the seconds it
    took, 0 where everything was built."""
    from gpu_image_processing_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    return time.perf_counter() - t0 if build.BUILD_SECONDS else 0.0


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             process_start: float, device: str = "cuda", alter=None,
             root=spec.ROOT, mix_overrides: dict | None = None,
             config_overrides: dict | None = None) -> dict:
    """The result of one run (the dict the last line prints).  `device`,
    `alter` and the overrides are for the tests, which run the harness on
    the CPU at small sizes with the program broken underneath."""
    cell = spec.load(cell_name, root, mix_overrides, config_overrides)
    on_card = device == "cuda"
    if on_card:
        chip.require_cards(cell.chips)
        print(chip.describe_host(), flush=True)
        print(f"portbench: build directory {chip.check_build_dir(root)}",
              flush=True)
    build_s = build_libraries() if on_card else 0.0
    if build_s:
        print(f"portbench: first run in this checkout: built the libraries in "
              f"{build_s:.3f} s, left out of setup_s", flush=True)
    ctx = Context(cell.config, cell.mix, seed, torch.device(device), alter)
    entry = ENTRIES[cell.mix["entry"]](ctx)
    try:
        t_setup = time.perf_counter()
        entry.setup()
        if on_card:
            torch.cuda.synchronize()
        print(f"portbench: set-up: {t_setup - process_start - build_s:.3f} s "
              f"to start (imports, the card, the build's check), "
              f"{time.perf_counter() - t_setup:.3f} s the program, inputs "
              f"and warm-up", flush=True)
        print(f"portbench: before the window: "
              f"{chip.sample_clocks() if on_card else 'no card'}", flush=True)
        before = entry.counters()
        tracer = DeviceTrace() if trace else None
        with tracer or contextlib.nullcontext():
            t0 = time.perf_counter() + 0.05
            setup_s = t0 - process_start - build_s
            win = entry.window(t0, t0 + seconds)
        t1 = t0 + seconds
        win = entry.collect(win)
        after = entry.counters()
        print(f"portbench: after the window: "
              f"{chip.sample_clocks() if on_card else 'no card'}", flush=True)
        peak = torch.cuda.max_memory_allocated(0) if on_card else 0
        entry.release()
        cmp = Comparison(cell.config["numerics"])
        sampled = entry.check(cmp)
    finally:
        close = getattr(entry, "close", None)
        if close:
            close()
    obs = {"calls": win.calls, "t0": t0, "t1": t1, "setup_s": setup_s,
           "before": before, "after": after,
           "trace": tracer.result if tracer else None,
           "work": [(c.filter, c.level, (*c.size, 3), c.radius)
                    for c in win.work]}
    metrics = {}
    for m, reader in (cell.per_layer if trace else cell.end_to_end):
        value = reader.read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for note in win.notes:
        print(f"portbench: window: {note}", flush=True)
    print(f"portbench: window calls {len(win.calls)}, output check on a "
          f"sample of {sampled} answers, seed {seed}", flush=True)
    numbers = cmp.numbers()
    failed = sum(not ok for _, _, ok in win.calls)
    # Last, once the program, the check and the readers have run: a module
    # loaded anywhere after the window shows here.
    loaded = chip.forbidden_modules()
    if loaded:
        raise chip.Forbidden(f"loaded after the window: {loaded}")
    result = {
        "correct": cmp.correct and failed == 0,
        "attempted": len(win.calls), "failed": failed, "metrics": metrics,
        "device": {**(chip.device_info(cell.chips) if on_card else
                      {"platform": "cpu", "kind": "cpu", "count": 0}),
                   "memory_peak_bytes": peak}}
    if tracer:
        result["device"].update(busy_s=tracer.result.busy_s,
                                window_s=tracer.result.window_s)
        result["breakdown"] = tracer.result.breakdown()
    result["checked"] = {k: [v["value"], v["limit"]] for k, v in numbers.items()}
    for note in cmp.notes:
        _err(f"portbench: check: {note}")
    for k, v in numbers.items():
        _err(f"portbench: compared {k} = {v['value']} (limit {v['limit']})")
    return result


def print_result(result: dict) -> None:
    print(json.dumps(result), flush=True)
