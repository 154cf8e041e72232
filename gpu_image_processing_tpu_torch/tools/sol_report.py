"""Speed-of-light report of the served kernels on the card: for gaussian
(sigma 2, r = 3), box (r = 5) and Sobel at levels 1, 2 and 4 on the full
2146x3239x3 image, each device row of a torch.profiler trace of the served
call (`profiling/profiler.py::profile_filter` on `FilterRuntime(device)`)
with its time, launches, share, and for a hand kernel its modeled bytes and
operations against the card's peaks: the % of each roofline and which one
binds.

The port of the JAX system's `scripts/sol_report.py`.  The models are the
package's (`profiling/traffic.py`): the bytes any implementation moves (the
image read once and written once), and the operations the kernel's function
needs at the float32 rate of one instruction an operation; the band
(level-4 gaussian from r = 3, `band_mma_rows`) runs its products on the
tensor cores, so its compute roofline is the tensor-core FLOPs it issues
(`served_tensor_core_flops`) against the dense bf16 peak, the dual roofline
the JAX report gave its matrix-unit tiers.  Peaks come from `PEAKS`; on a
card not in it, and on the CPU (where there is no trace: the plain versions
run and are timed by the host clock), no percentage is given.

The sanity rules of the JAX report, as pure functions: a launch shorter
than `TRACE_RESOLUTION_MS` gets no rate, and a rate past
`SOL_IMPOSSIBLE_PCT` of its peak is flagged and kept as an implied rate, not
printed as a percentage.  `--check` gates every traced row: each hand kernel
with at least `CHECK_SHARE_PCT` of the row's time must carry bytes, a % of
its bound and the binding bound, none impossible; a level-2 or level-4 row
must list a hand kernel; shares sum to at most 100.5.  Level-1 rows are
plain torch elementwise kernels, for which the trace gives no bytes: they
are listed with times and shares and not gated, as the JAX check skips rows
without a per-op table.

Usage, from the root of the repository:

    python -m gpu_image_processing_tpu_torch.tools.sol_report \
        [--check] [--device cuda|cpu] [--out-dir DIR]

Prints a table and writes `sol_report.json`.  Without CUDA it raises unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

from ..profiling.profiler import (DevicePeaks, device_peaks, profile_filter,
                                  short_kernel_name)
from ..profiling.traffic import (io_bytes, kernel_operations,
                                 served_tensor_core_flops)
from ..runtime.dispatch import FilterRuntime
from .verification import (common_arguments, device_report, launch_counts,
                           write_report)

FULL = (2146, 3239, 3)          # the README image (bench.py:34,50-52)
SEED = 0                        # scripts/sol_report.py:176
CONFIGS = (("gaussian", {"sigma": 2.0, "radius": 3}),
           ("box", {"radius": 5}),
           ("sobel", {}))
LEVELS = (1, 2, 4)
#: A hand kernel must carry its roofline once it holds this share of the
#: row's traced time.
CHECK_SHARE_PCT = 5.0
#: Launches at or below this are trace-quantization noise: no rate.
TRACE_RESOLUTION_MS = 0.002
#: Rates past this % of their peak are impossible: flagged, never printed.
SOL_IMPOSSIBLE_PCT = 110.0
#: Fragments of the hand kernels' names in a trace, and the kernel (its
#: `LAUNCHES` key) each belongs to.
TRACE_KERNELS = (
    ("gauss_window_rows<gip::Weighted", "gaussian_rows"),
    ("gauss_pair_rows", "gaussian_rows"),
    ("gauss_window_rows<gip::Folded", "gaussian_folded_rows"),
    ("gauss_window_rows<gip::Box", "box_rows"),
    ("box_window_rows", "box_rows"),
    ("box_wide_", "box_rows"),
    ("band_mma_rows", "gaussian_band_rows"),
    ("sobel_tile_rows<true", "sobel_rows"),
    ("sobel_tile_rows<false", "sobel_f32_rows"),
)


def hand_kernel(trace_name: str) -> Optional[str]:
    """The hand kernel a trace row belongs to, or None (a torch kernel)."""
    for fragment, kernel in TRACE_KERNELS:
        if fragment in trace_name:
            return kernel
    return None


def kernel_model(kernel: str, filter_name: str, level: int,
                 shape: tuple[int, int, int], radius: int) -> dict[str, Any]:
    """Modeled bytes and operations of one launch of `kernel` serving this
    request, and the rate its operations run at."""
    height, width, channels = shape
    flops = served_tensor_core_flops(filter_name, level, height, width,
                                     channels, radius)
    if kernel == "gaussian_band_rows" and flops:
        ops, rate = flops, "bf16_tensor"
    else:
        ops, rate = kernel_operations(kernel, shape, radius), "f32"
    return {"bytes": io_bytes(*shape), "operations": ops, "rate": rate}


def make_op_entry(name: str, rec: dict[str, float], traced_total: float,
                  peaks: Optional[DevicePeaks],
                  model: Optional[dict[str, Any]] = None) -> dict[str, Any]:
    """One trace row's report entry, rates sanity-bounded.  `rec` is a row
    of `trace_kernel_stats`; `model` (`kernel_model`) attaches a hand
    kernel's bytes and operations.  A pure function of its arguments."""
    avg = rec["avg_ms"]
    entry: dict[str, Any] = {
        "op": short_kernel_name(name),
        "kernel": hand_kernel(name),
        "avg_ms": avg,
        "launches": rec["count"],
        "per_call_ms": rec["per_call_ms"],
        "share_pct": (100.0 * rec["per_call_ms"] / traced_total
                      if traced_total else None),
        "bytes": None, "bytes_source": None, "gbps": None, "sol_pct": None,
        "operations": None, "ops_rate": None, "ops_per_s": None,
        "sol_pct_ops": None, "bound": None, "pct_of_bound": None,
    }
    if not model or avg <= 0:
        return entry
    entry.update(bytes=model["bytes"], bytes_source="modeled",
                 operations=model["operations"], ops_rate=model["rate"])
    gbps = model["bytes"] / (avg / 1e3) / 1e9
    ops_per_s = model["operations"] / (avg / 1e3)
    if avg < TRACE_RESOLUTION_MS:
        entry.update(sol_note="sub-resolution", implied_gbps=gbps,
                     implied_ops_per_s=ops_per_s)
        return entry
    entry.update(gbps=gbps, ops_per_s=ops_per_s)
    if peaks is None:
        return entry
    peak_ops = (peaks.bf16_tensor_ops_per_s if model["rate"] == "bf16_tensor"
                else peaks.f32_ops_per_s)
    bytes_pct = 100.0 * gbps * 1e9 / peaks.hbm_bytes_per_s
    ops_pct = 100.0 * ops_per_s / peak_ops
    if bytes_pct > SOL_IMPOSSIBLE_PCT or ops_pct > SOL_IMPOSSIBLE_PCT:
        # The model or the timing is broken: never print the division.
        entry.update(gbps=None, ops_per_s=None, implied_gbps=gbps,
                     implied_ops_per_s=ops_per_s,
                     sol_note=("exceeds-peak" if bytes_pct > SOL_IMPOSSIBLE_PCT
                               else "ops-exceeds-peak"))
        return entry
    bound = "bytes" if bytes_pct >= ops_pct else "operations"
    entry.update(sol_pct=bytes_pct, sol_pct_ops=ops_pct, bound=bound,
                 pct_of_bound=max(bytes_pct, ops_pct),
                 bound_ms=avg * max(bytes_pct, ops_pct) / 100.0)
    return entry


def profile_row(rt: FilterRuntime, image: np.ndarray, filter_name: str,
                level: int, params: dict[str, Any],
                peaks: Optional[DevicePeaks]) -> dict[str, Any]:
    """One served config's row: every device row of its trace."""
    deep = profile_filter(rt, image, filter_name, level, **params)
    stats = deep.get("trace_kernel_stats") or {}
    traced_total = deep.get("trace_total_ms") or deep["total_kernel_duration_ms"]
    radius = params.get("radius", 1)
    # The model goes on the longest row of each hand kernel (one launch a
    # call on every route here).
    main_row: dict[str, str] = {}
    for name in sorted(stats, key=lambda n: -stats[n]["per_call_ms"]):
        kernel = hand_kernel(name)
        if kernel is not None:
            main_row.setdefault(kernel, name)
    ops = [make_op_entry(
        name, rec, traced_total, peaks,
        kernel_model(hand_kernel(name), filter_name, level, image.shape, radius)
        if main_row.get(hand_kernel(name)) == name else None)
        for name, rec in sorted(stats.items(), key=lambda kv: -kv[1]["per_call_ms"])]
    return {"filter": filter_name, "level": level, "params": params,
            "duration_source": deep.get("duration_source"),
            "serving_path": deep["config"].get("Serving Path"),
            "total_ms": deep["total_kernel_duration_ms"],
            "traced_total_ms": traced_total, "ops": ops}


def _fmt(op: dict[str, Any]) -> str:
    if op.get("pct_of_bound") is not None:
        return (f"{op['pct_of_bound']:.1f}% of bound ({op['bound']}-bound; "
                f"bytes {op['sol_pct']:.1f}%, {op['ops_rate']} operations "
                f"{op['sol_pct_ops']:.1f}%)")
    if op.get("sol_note"):
        return f"-- ({op['sol_note']}, implied {op.get('implied_gbps', 0):.1f} GB/s)"
    if op.get("gbps") is not None:
        return f"{op['gbps']:.1f} GB/s (no peak table)"
    return "no bytes (torch kernel)" if op["kernel"] is None else "no bytes"


def build_report(rt: FilterRuntime, image: np.ndarray,
                 levels: tuple[int, ...] = LEVELS) -> dict[str, Any]:
    """Every config's row, printed as it is measured."""
    name = (torch.cuda.get_device_name(rt.device) if rt.device.type == "cuda"
            else None)
    peaks = device_peaks(name)
    rows = []
    for level in levels:
        for filter_name, params in CONFIGS:
            row = profile_row(rt, image, filter_name, level, params, peaks)
            rows.append(row)
            print(f"\n{filter_name} L{level}: {row['total_ms']:.4f} ms a call "
                  f"[{row['duration_source']}, {row['serving_path']}]")
            for op in row["ops"]:
                print(f"  {op['op'][:60]:60} {op['avg_ms']:8.4f} ms "
                      f"x{op['launches']:<3} {op['share_pct'] or 0:5.1f}%  "
                      f"{_fmt(op)}")
    return {"device": device_report(rt.device),
            "shape": list(image.shape),
            "peaks": peaks._asdict() if peaks else None, "rows": rows}


def check(payload: dict[str, Any]) -> list[str]:
    """The problems of a report: see the module's docstring."""
    problems = []
    has_peak = bool(payload.get("peaks"))
    for row in payload["rows"]:
        if row.get("duration_source") != "torch_profiler_trace":
            continue   # no per-kernel table (the CPU): nothing to gate
        where = f"{row['filter']} L{row['level']}"
        if row["level"] != 1 and not any(op["kernel"] for op in row["ops"]):
            problems.append(f"{where}: the trace lists no hand kernel")
        for op in row["ops"]:
            share = op.get("share_pct") or 0.0
            if op["kernel"] is None or share < CHECK_SHARE_PCT:
                continue
            what = f"{where} {op['op']}"
            if op.get("bytes") is None:
                problems.append(f"{what}: {share:.1f}% of traced time but "
                                "bytes=null")
                continue
            note = op.get("sol_note")
            if note in ("exceeds-peak", "ops-exceeds-peak"):
                problems.append(f"{what}: modeled work implies a rate past "
                                f"peak ({note})")
            elif has_peak and note is None and (
                    op.get("pct_of_bound") is None or op.get("bound") is None):
                problems.append(f"{what}: {share:.1f}% of traced time but no "
                                "% of bound or binding bound")
            for key in ("sol_pct", "sol_pct_ops", "pct_of_bound"):
                if (op.get(key) or 0.0) > SOL_IMPOSSIBLE_PCT:
                    problems.append(f"{what}: prints impossible {key} "
                                    f"{op[key]:.1f}%")
        total = sum(op.get("share_pct") or 0.0 for op in row["ops"])
        if total > 100.5:
            problems.append(f"{where}: shares sum to {total:.1f}% (> 100)")
    return problems


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="exit 1 if a dominant hand kernel lacks a "
                             "trustworthy % of its bound")
    common_arguments(parser, workers=False)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    rt = FilterRuntime(args.device)
    image = np.random.default_rng(SEED).integers(0, 256, FULL, np.uint8)
    payload = build_report(rt, image)
    payload["launches"] = launch_counts()
    payload["seconds"] = time.perf_counter() - t0
    problems = check(payload)
    payload["problems"] = problems
    path = write_report(args.out_dir, "sol_report", payload)
    print(f"\nLAUNCHES {json.dumps(payload['launches'])}")
    print(f"report {path}; {payload['seconds']:.1f} s")
    if args.check:
        if problems:
            print("SOL CHECK FAILED:")
            for p in problems:
                print("  " + p)
            return 1
        print("SOL CHECK OK: every dominant hand kernel carries its bytes, "
              "its % of bound and the binding bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
