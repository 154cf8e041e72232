"""Time the rows blur and Sobel kernels of one or two checkouts on the card.

Usage, from the root of the repository:

    python3 gpu_image_processing_tpu_torch/tools/kernel_times.py \
        [--root DIR] [--ref DIR]

imports `gpu_image_processing_tpu_torch` from DIR (default: the checkout
this file lies in), builds its kernels, and times each case below on a
seeded 2146x3239 RGB image with CUDA events: the mean of ITERS back-to-back
launches, right after WARM untimed ones (a card that idled, as while a
library builds, raises its clocks only under load), the least of REPEATS
such runs.  Before each run the card sleeps (`torch.cuda._sleep`) while the
host queues the run's launches, so the events time the kernels and not the
wrappers' host work, which for a kernel of tens of microseconds takes about
as long; the host's microseconds a launch (host clock around the queueing,
least of the runs) are printed beside them.  The cases: `gaussian_rows` at r = 1, 3, 15, 20 (a radius without a kernel of
its own), 31 and `gaussian_folded_rows` at r = 1, 2 (sigma as `GAUSS`),
each given its table where its checkout's kernel takes it (on the host, or
on the card where an older checkout reads it there), `sobel_rows` and
`sobel_f32_rows`, `box_rows` at r = 1, 5, 7, 8, 15, 40 and 4000 (wider than the
image), and `gaussian_band_rows` at r = 3, 15, 31 on the (H, W*C) rows and
on the (3, H, W) planes of the same image; the planar blur (K5:
`gaussian_planar` at r = 1, 2, 3, 5, 15, 20, 31, `gaussian_folded_planar` at
r = 1, 2, `box_planar` at r = 1, 5, 7, 8, 15, 31) and the planar Sobel (K7:
`sobel_planar`, `sobel_f32_planar`) on the (3, H, W) planes, K5 on the 12
planes of 4 images and K7 on (4, 3, H, W), their halo-row modes on rows
BAND of the planes (with `zero_rows=False` for K7, which it also takes
without halo rows), and the models' forward on the (H, W, 3) tensor
(`GaussianBlur(level=2)`, `SobelEdgeDetection(level=2)`).

With --ref, it also imports the package of a second checkout, REF, under
another module name (the package imports itself only relatively), so that
both are timed in one process on one card, in the order REF, ROOT, ROOT,
REF for every case: drift of the card touches both alike.  It calls only
wrappers whose signatures every version of the port has kept.

It prints one line per case and, last, one JSON line: the card's name and
power limit as nvidia-smi gives them, the roots, each case's times in ms
and its host microseconds a launch.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

FULL = (2146, 3239, 3)        # the README image (bench.py:34,50-52)
SEED = 1234
ITERS = 20
WARM = 10
REPEATS = 3
# Cycles the card sleeps before a timed run: about 25 ms at 1.98 GHz, longer
# than the host takes to queue ITERS launches.
SLEEP_CYCLES = 50_000_000
PACKAGE = "gpu_image_processing_tpu_torch"
BOX_RADII = (1, 5, 7, 8, 15, 40, 4000)
GAUSS = ((1, 1.0), (3, 2.0), (15, 8.0), (20, 8.0), (31, 8.0))   # (radius, sigma)
FOLDED = ((1, 1.0), (2, 1.5))
BAND = ((3, 2.0), (15, 5.0), (31, 8.0))
PLANAR_GAUSS = ((1, 1.0), (2, 1.5), (3, 2.0), (5, 2.5), (15, 8.0), (20, 8.0),
                (31, 8.0))
PLANAR_BOX_RADII = (1, 5, 7, 8, 15, 31)
HALO_ROWS = (700, 1500)   # rows [a, b) of the planes, given with halo rows
MODULES = ("ops.cuda.blur", "ops.cuda.sobel", "ops.weights",
           "ops.cuda.blur_planar", "ops.cuda.sobel_planar", "models.filters")


def load_package(root: str, name: str):
    """The `MODULES` of the package under `root`, imported as the package
    `name`."""
    if name == PACKAGE:
        sys.path.insert(0, root)
    else:
        pkg = Path(root) / PACKAGE
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    mods = [importlib.import_module(f"{name}.{m}") for m in MODULES]
    if not mods[0].__file__.startswith(str(Path(root).resolve())):
        raise RuntimeError(f"imported {mods[0].__file__}, not from {root}")
    return mods


def gaussian_table(weights, fn, rows, table, radius: int, channels: int):
    """`table` where the checkout's `fn` takes it: on the host where its
    kernel takes the taps by value; where it refuses a host table, on the
    card."""
    import torch

    host = weights.weights_to_torch(table, torch.device("cpu"))
    try:
        fn(rows, host, radius, channels)
    except ValueError:
        return host.to(rows.device)
    return host


def cases(blur, sobel, weights, blur_planar, sobel_planar, models, rows,
          planes, width: int, channels: int) -> dict:
    """name -> zero-argument launch of one checkout's kernel."""
    dev = rows.device
    out = {}
    for name, fn, table in (("gaussian_rows", blur.gaussian_rows, GAUSS),
                            ("gaussian_folded_rows", blur.gaussian_folded_rows,
                             FOLDED)):
        for r, sigma in table:
            wr = gaussian_table(weights, fn, rows,
                                weights.gaussian_kernel_f32(r, sigma), r, channels)
            out[f"{name} r={r}"] = (
                lambda fn=fn, r=r, wr=wr: fn(rows, wr, r, channels))
    out["sobel_rows"] = lambda: sobel.sobel_rows(rows, width, channels)
    out["sobel_f32_rows"] = lambda: sobel.sobel_f32_rows(rows, width, channels)
    for r in BOX_RADII:
        out[f"box_rows r={r}"] = (
            lambda r=r: blur.box_rows(rows, r, channels))
    for r, sigma in BAND:
        hi, lo = (weights.weights_to_torch(t, dev) for t in
                  weights.bf16_split(weights.gaussian_kernel_f32(r, sigma)))
        out[f"gaussian_band_rows r={r} rows"] = (
            lambda r=r, hi=hi, lo=lo: blur.gaussian_band_rows(rows, hi, lo, r,
                                                              channels))
        out[f"gaussian_band_rows r={r} planes"] = (
            lambda r=r, hi=hi, lo=lo: blur.gaussian_band_rows(planes, hi, lo,
                                                              r, 1))
    out.update(planar_cases(weights, blur_planar, sobel_planar, models, planes))
    return out


def planar_cases(weights, blur_planar, sobel_planar, models, planes) -> dict:
    """The planar kernels' cases (K5, K7) and the models' forward."""
    c, h, w = planes.shape
    batch4 = planes.unsqueeze(0).repeat(4, 1, 1, 1)   # (4, C, H, W)
    planes12 = batch4.view(4 * c, h, w)
    a, b = HALO_ROWS
    out = {}
    for name, fn, table in (
            ("gaussian_planar", blur_planar.gaussian_planar, PLANAR_GAUSS),
            ("gaussian_folded_planar", blur_planar.gaussian_folded_planar,
             PLANAR_GAUSS[:2])):
        for r, sigma in table:
            wr = gaussian_table(weights, lambda x, t, rr, _c: fn(x, t, rr),
                                planes, weights.gaussian_kernel_f32(r, sigma),
                                r, 1)
            out[f"{name} r={r}"] = lambda fn=fn, r=r, wr=wr: fn(planes, wr, r)
            if r == 3:
                band = planes[:, a - r:b + r].contiguous()
                out[f"{name} r={r} 4 images"] = (
                    lambda fn=fn, r=r, wr=wr: fn(planes12, wr, r))
                out[f"{name} r={r} halo rows {a}-{b}"] = (
                    lambda fn=fn, r=r, wr=wr, band=band: fn(band, wr, r, True))
    for r in PLANAR_BOX_RADII:
        out[f"box_planar r={r}"] = lambda r=r: blur_planar.box_planar(planes, r)
    box_band = planes[:, a - 5:b + 5].contiguous()
    out[f"box_planar r=5 halo rows {a}-{b}"] = (
        lambda: blur_planar.box_planar(box_band, 5, True))
    sobel_band = planes[None, :, a - 1:b + 1].contiguous()
    for name, fn in (("sobel_planar", sobel_planar.sobel_planar),
                     ("sobel_f32_planar", sobel_planar.sobel_f32_planar)):
        out[name] = lambda fn=fn: fn(planes)
        out[f"{name} 4 images"] = lambda fn=fn: fn(batch4)
        out[f"{name} zero_rows=False"] = lambda fn=fn: fn(planes, False, False)
        out[f"{name} halo rows {a}-{b} zero_rows=False"] = (
            lambda fn=fn: fn(sobel_band, True, False))
    image = planes.permute(1, 2, 0).contiguous()
    gauss = models.GaussianBlur(2.0, 3, 2).to(planes.device)
    edges = models.SobelEdgeDetection(2)
    out["GaussianBlur(level=2) forward"] = lambda: gauss(image)
    out["SobelEdgeDetection(level=2) forward"] = lambda: edges(image)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="checkout whose package is timed")
    parser.add_argument("--ref", default=None,
                        help="a second checkout, timed in the same process")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    h, w, c = FULL
    image = np.random.default_rng(SEED).integers(0, 256, size=FULL, dtype=np.uint8)
    rows = torch.from_numpy(image.reshape(h, w * c)).to(dev)
    planes = rows.view(h, w, c).permute(2, 0, 1).contiguous()

    roots = {"root": str(Path(args.root).resolve())}
    if args.ref:
        roots["ref"] = str(Path(args.ref).resolve())
    arms = {arm: cases(*load_package(root, PACKAGE if arm == "root"
                                     else "gip_ref_checkout"),
                       rows, planes, w, c)
            for arm, root in roots.items()}

    def event_ms(fn) -> tuple[float, float]:
        """(card ms, host us) a launch."""
        for _ in range(WARM):
            fn()
        runs, host = [], []
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fn()
            host.append((time.perf_counter() - t0) / ITERS * 1e6)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / ITERS)
        return min(runs), min(host)

    for arm in arms.values():   # build, load and warm
        for fn in arm.values():
            fn()
    torch.cuda.synchronize()
    order = ["ref", "root", "root", "ref"] if "ref" in arms else ["root"] * 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    times, host_us = {}, {}
    for name in arms["root"]:
        got = {arm: [] for arm in arms}
        hosts = {arm: [] for arm in arms}
        for arm in order:
            ms, us = event_ms(arms[arm][name])
            got[arm].append(ms)
            hosts[arm].append(us)
        times[name], host_us[name] = got, hosts
        line = "; ".join(f"{arm} " + ", ".join(f"{t:.4f}" for t in ts)
                         for arm, ts in got.items())
        ratio = ""
        if "ref" in got:
            ratio = f"; root / ref {sum(got['root']) / sum(got['ref']):.3f}"
        host = "; ".join(f"{arm} {min(us):.1f}" for arm, us in hosts.items())
        print(f"[{card}] {name} {h}x{w}x{c}: {line} ms{ratio}; host us a "
              f"launch {host}", flush=True)
    print(json.dumps({"card": card, "shape": list(FULL), "roots": roots,
                      "order": order, "ms": times, "host_us": host_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
