"""Count the launches that torch.profiler sessions keep on the card, by the
host time between a session's opening and its first launch and between its
last launch's end and its closing (the margins of `profiler.traced`).

Usage, from the root of the repository:

    python -m gpu_image_processing_tpu_torch.tools.trace_margins \
        [--seconds 150] [--conditions 0:0:0:0,20:0:0:0,0:20:0:0,20:20:0:0] \
        [--fresh-thread] [--cudart-shared] [--out-dir DIR]

For `--seconds`, it opens session after session, the conditions in turn
(lead:tail:idle:primers: host ms from the session's opening to its first
launch, host ms from the end of its device work to its closing, ms with
the card idle before the session, and spins launched first in it, as
`profiler.traced` launches its primers), as `profiler._measure` does: the
card's timing lock held, the served call prepared and run once untimed,
then `REPS` runs of it in the session, each followed by a torch
elementwise kernel; with `--fresh-thread`, each session in a thread of its
own, as the threaded server opens them.  The
call cycles through gaussian (r = 3), box (r = 5) and Sobel at level 2 on
a seeded 2146x3239x3 image.  For each session it compares the hand-kernel
launches in the trace (`profiler.traced_launches`) with `ops.cuda.LAUNCHES`,
counts the torch kernels (the multiplies) in the trace, finds which
kernel launches on the host (the `cudaLaunchKernel` events, and the
`cudaGraphLaunch` of a served call's graph), in order, have
their kernel in the trace, and takes the least skew of a kernel's device
start behind the start of its launch: a negative skew is a kernel dated
before it was launched.

`--cudart-shared` builds the kernel libraries with `-cudart shared` (into
`_build_cudart_shared/` beside the build directory), so that they launch
through PyTorch's CUDA runtime instead of one linked into each library.

It prints one line per condition (sessions, primers lost, sessions that
lost hand-kernel launches, sessions that lost a torch kernel, the patterns
of kept launches of the others, skew percentiles in us) with the card's name and power limit, and writes `trace_margins.json`
into `--out-dir`.  The card only.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda import LAUNCHES, build
from .verification import OUT_DIR, device_report, write_report

REPS = 4
CALLS = (("gaussian", 3), ("box", 5), ("sobel", 3))
FULL = (2146, 3239, 3)
SEED = 0


def parse_conditions(text: str) -> list[tuple[float, float, float, int]]:
    """"l:t:i:p,..." -> [(lead_ms, tail_ms, idle_ms, primers), ...]."""
    out = []
    for part in text.split(","):
        lead, tail, idle, primers = part.split(":")
        out.append((float(lead), float(tail), float(idle), int(primers)))
    return out


def session(rt, image, filt: str, radius: int,
            condition: tuple[float, float, float, int],
            scratch: torch.Tensor) -> dict:
    """One session's counts and least skew (us; None without a launch
    event to compare)."""
    from torch.profiler import ProfilerActivity, profile

    from ..profiling import profiler
    from ..runtime.timing import exclusive

    lead_ms, tail_ms, idle_ms, primers = condition
    call = rt._single_call(filt, image, 2, 2.0, radius)
    # The served call: its executable held with the image staged, so the
    # session traces the runs that serve it (its graph's replays once the
    # key has repeated).
    with call.staged():
        with exclusive(call.devices):
            call.run()
        device = call.devices[0]
        torch.cuda.synchronize(device)
        time.sleep(idle_ms / 1e3)
        with profiler._SESSION_LOCK, exclusive(call.devices):
            torch.cuda.synchronize(device)
            made = sum(LAUNCHES.values())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(primers):
                    torch.cuda._sleep(1)
                time.sleep(lead_ms / 1e3)
                for _ in range(REPS):
                    call.run()
                    scratch.mul_(1.0)
                torch.cuda.synchronize(device)
                time.sleep(tail_ms / 1e3)
            made = sum(LAUNCHES.values()) - made
    averages = prof.key_averages()
    counts = profiler.traced_launches(profiler._trace_kernels(averages, REPS))
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() != cuda
                      and ("LaunchKernel" in e.name() or "GraphLaunch" in e.name()))
    started = {}
    for e in events:
        if e.device_type() == cuda:
            for corr in (e.correlation_id(), e.linked_correlation_id()):
                started.setdefault(corr, e.start_ns())
    skews = [(started[c] - t) / 1e3 for t, c in launches if c in started]
    return {"made": made, "traced": sum(counts.values()) - counts["box_wide_v"],
            "primers_kept": profiler.primers_kept(averages),
            "torch_kernels": sum(e.device_type() == cuda and "MulFunctor" in e.name()
                                 for e in events),
            # Which of the session's kernel launches, in order, the trace kept.
            "kept_in_order": "".join("1" if c in started else "0"
                                     for _, c in launches),
            "least_skew_us": min(skews) if skews else None}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=150.0)
    parser.add_argument("--conditions",
                        default="0:0:0:0,20:0:0:0,0:20:0:0,20:20:0:0",
                        help="lead:tail:idle:primers, comma-separated")
    parser.add_argument("--fresh-thread", action="store_true")
    parser.add_argument("--cudart-shared", action="store_true")
    parser.add_argument("--out-dir", default=str(OUT_DIR))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_margins: CUDA is not available", file=sys.stderr)
        return 1
    if args.cudart_shared:
        build.NVCC_FLAGS = (*build.NVCC_FLAGS, "-cudart", "shared")
        build.BUILD_DIR = Path(f"{build.BUILD_DIR}_cudart_shared")
    from ..runtime.dispatch import FilterRuntime
    from ..runtime.device import describe

    conditions = parse_conditions(args.conditions)
    rt = FilterRuntime("cuda")
    image = np.random.default_rng(SEED).integers(0, 256, FULL, np.uint8)
    scratch = torch.zeros(1 << 20, device=rt.device)
    build.build_all(build.SOURCES)
    t0 = time.perf_counter()
    records = []
    i = 0
    while time.perf_counter() - t0 < args.seconds:
        condition = conditions[i % len(conditions)]
        filt, radius = CALLS[(i // len(conditions)) % len(CALLS)]
        if args.fresh_thread:
            with ThreadPoolExecutor(1) as pool:   # a new thread a session
                rec = pool.submit(session, rt, image, filt, radius, condition,
                                  scratch).result()
        else:
            rec = session(rt, image, filt, radius, condition, scratch)
        records.append({"condition_ms": condition, "filter": filt,
                        "age_s": time.perf_counter() - t0, **rec})
        i += 1
    card = describe(rt.device)["name_power_limit"]
    summary = []
    for condition in conditions:
        recs = [r for r in records if r["condition_ms"] == condition]
        skews = [r["least_skew_us"] for r in recs if r["least_skew_us"] is not None]
        lost = Counter(r["made"] - r["traced"] for r in recs if r["made"] != r["traced"])
        kept = Counter(r["kept_in_order"] for r in recs
                       if "0" in r["kept_in_order"])
        primers_lost = Counter(condition[3] - r["primers_kept"] for r in recs
                               if r["primers_kept"] != condition[3])
        row = {"condition_ms": condition, "sessions": len(recs),
               "primers_lost": dict(primers_lost),
               "lost_hand_launches": sum(r["made"] != r["traced"] for r in recs),
               "lost_by_count": dict(lost),
               "lost_torch_kernels": sum(r["torch_kernels"] != REPS for r in recs),
               "kept_in_order": dict(kept),
               "least_skew_us_pct": dict(zip(
                   ("0", "1", "5", "50", "99", "100"),
                   np.percentile(skews, [0, 1, 5, 50, 99, 100]).round(1).tolist()))
               if skews else None}
        summary.append(row)
        print(f"[{card}] lead:tail:idle:primers "
              f"{':'.join(f'{x:g}' for x in condition)}: {row['sessions']} "
              f"sessions, primers lost {row['primers_lost']}, "
              f"{row['lost_hand_launches']} lost "
              f"hand-kernel launches {row['lost_by_count']}, "
              f"{row['lost_torch_kernels']} lost a torch kernel (launches kept, "
              f"in order: {row['kept_in_order']}); least skew of "
              f"a kernel behind its launch, us, percentiles "
              f"{row['least_skew_us_pct']}", flush=True)
    path = write_report(args.out_dir, "trace_margins", {
        "device": device_report(rt.device), "card": card, "torch": torch.__version__,
        "cudart_shared": args.cudart_shared, "fresh_thread": args.fresh_thread,
        "reps": REPS,
        "seconds": args.seconds, "summary": summary, "sessions": records})
    print(f"report {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
