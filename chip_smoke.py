#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each of which fails the run on its own:

1. device: CUDA present, compute capability 9.0; prints the card, its power
   limit and the toolchain;
2. build: builds every kernel of the main path from the sources with nvcc;
3. kernel vs plain: each kernel against its plain torch version on the card,
   at small shapes, edge shapes and the full 2146x3239 RGB image; gaussian,
   box and grey Sobel must agree exactly, colour Sobel within the bound of
   tests/sobel_tolerance.py; the level-2 API on a small image against the
   numpy oracle;
4. main path: the `gpu_filters` API and `run_all_levels` on the full image
   through FilterRuntime(cuda), with every kernel's launch count read around
   that run, and a torch.profiler trace that must list the kernels;
5. times: the API's metrics, and each kernel's CUDA-event time beside its
   plain version's.

The line before the last is a JSON object `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`.  Any failure exits non-zero and prints no ok
line, as does a host without CUDA or a directory without the package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gpu_image_processing_tpu_torch.api import filters as api
from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES, blur, build, sobel
from gpu_image_processing_tpu_torch.ops.weights import (
    gaussian_kernel_f32, weights_to_torch)
from gpu_image_processing_tpu_torch.runtime.device import describe
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from tests import oracle_numpy as oracle

FULL = (2146, 3239, 3)        # the README image (bench.py:34,50-52)
SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4), (2, 2, 3), (1, 7, 1), FULL]
GAUSS = [(1, 1.0), (3, 2.0), (15, 8.0), (31, 8.0)]   # (radius, sigma)
BOX_RADII = [1, 2, 5, 15, 40]
MAIN_SIGMA, MAIN_GAUSS_RADIUS, MAIN_BOX_RADIUS = 2.0, 3, 5
SEED = 1234
# tests/sobel_tolerance.py: colour Sobel may differ by <= 6 on <= 0.1% of
# pixels (a grey value on a .5 tie rounds either way under FMA contraction).
SOBEL_MAX_DIFF, SOBEL_MAX_FRACTION = 6, 1e-3

KERNELS = {
    "gaussian_rows": {
        "source": "gpu_image_processing_tpu_torch/ops/cuda/blur.cu",
        "replaces": "gpu_image_processing_tpu/ops/pallas/blur.py:212",
        "also_replaces": [],
        "profiler_names": ["blur_h<false>", "blur_v<false>"],
    },
    "box_rows": {
        "source": "gpu_image_processing_tpu_torch/ops/cuda/blur.cu",
        "replaces": "gpu_image_processing_tpu/ops/pallas/blur_mxu.py:190",
        "also_replaces": ["gpu_image_processing_tpu/ops/pallas/blur.py:212"],
        "profiler_names": ["blur_h<true>", "blur_v<true>"],
    },
    "sobel_rows": {
        "source": "gpu_image_processing_tpu_torch/ops/cuda/sobel.cu",
        "replaces": "gpu_image_processing_tpu/ops/pallas/sobel_mxu.py:174",
        "also_replaces": ["gpu_image_processing_tpu/ops/pallas/sobel.py:162"],
        "profiler_names": ["sobel_l2"],
    },
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # -- 1. device ----------------------------------------------------------
    card_info = describe(dev)
    cap = card_info["capability"]
    require(cap == (9, 0), f"needs compute capability 9.0, found {cap}")
    card = card_info["name_power_limit"]
    print(card)
    nvcc_version = next(
        line for line in subprocess.run(
            [build.nvcc_path(), "--version"], capture_output=True, text=True,
            check=True).stdout.splitlines() if "release" in line)
    print(f"device: {card_info['name']}, capability {cap}, "
          f"count {torch.cuda.device_count()}")
    print(f"toolchain: torch {card_info['torch']}, torch CUDA "
          f"{card_info['cuda']}, nvcc {nvcc_version}")
    print("build route: nvcc -shared -Xcompiler -fPIC, extern \"C\" launch "
          "functions loaded with ctypes")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    probe = torch.zeros((3, 9), dtype=torch.uint8, device=dev)
    w3 = weights_to_torch(gaussian_kernel_f32(1, 1.0), dev)
    blur.gaussian_rows(probe, w3, 1, 3)   # builds blur.cu
    sobel.sobel_rows(probe, 3, 3)         # builds sobel.cu
    torch.cuda.synchronize()
    print(f"build: {time.perf_counter() - t0:.1f} s for blur.cu and sobel.cu "
          f"(first launch included)")
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernel vs plain -------------------------------------------------
    max_err = {name: 0 for name in KERNELS}

    def absdiff(a, b):
        return (a.to(torch.int32) - b.to(torch.int32)).abs()

    for h, w, c in SHAPES:
        img = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        rows = torch.from_numpy(img.reshape(h, w * c)).to(dev)
        for radius, sigma in GAUSS:
            wts = weights_to_torch(gaussian_kernel_f32(radius, sigma), dev)
            d = int(absdiff(blur.gaussian_rows(rows, wts, radius, c),
                            blur.gaussian_rows_plain(rows, wts, radius, c)).max())
            max_err["gaussian_rows"] = max(max_err["gaussian_rows"], d)
            print(f"compare gaussian {h}x{w}x{c} r={radius} sigma={sigma}: maxdiff {d}")
            require(d == 0, f"gaussian {h}x{w}x{c} r={radius}: maxdiff {d}")
        for radius in BOX_RADII:
            d = int(absdiff(blur.box_rows(rows, radius, c),
                            blur.box_rows_plain(rows, radius, c)).max())
            max_err["box_rows"] = max(max_err["box_rows"], d)
            print(f"compare box {h}x{w}x{c} r={radius}: maxdiff {d}")
            require(d == 0, f"box {h}x{w}x{c} r={radius}: maxdiff {d}")
        diff = absdiff(sobel.sobel_rows(rows, w, c),
                       sobel.sobel_rows_plain(rows, w, c))
        d, frac = int(diff.max()), float((diff > 0).float().mean())
        max_err["sobel_rows"] = max(max_err["sobel_rows"], d)
        print(f"compare sobel {h}x{w}x{c}: maxdiff {d}, fraction {frac:.2e}")
        if c == 1:
            require(d == 0, f"grey sobel {h}x{w}: maxdiff {d}")
        else:
            require(d <= SOBEL_MAX_DIFF and frac <= SOBEL_MAX_FRACTION,
                    f"colour sobel {h}x{w}x{c}: maxdiff {d}, fraction {frac}")
    torch.cuda.synchronize()

    rt = FilterRuntime(dev)
    small = rng.integers(0, 256, size=(24, 31, 3), dtype=np.uint8)
    got = api.gaussian_blur(small, MAIN_SIGMA, MAIN_GAUSS_RADIUS, 2, runtime=rt)
    want = oracle.gaussian_blur(
        small, gaussian_kernel_f32(MAIN_GAUSS_RADIUS, MAIN_SIGMA), MAIN_GAUSS_RADIUS)
    require(np.array_equal(got["image"], want), "gaussian L2 != numpy oracle")
    got = api.box_blur(small, MAIN_BOX_RADIUS, 2, runtime=rt)
    require(np.array_equal(got["image"], oracle.box_blur(small, MAIN_BOX_RADIUS)),
            "box L2 != numpy oracle")
    got = api.sobel_edge_detection(small, 2, runtime=rt)
    sd = np.abs(got["image"].astype(int) - oracle.sobel(small, 2))
    require(sd.max() <= SOBEL_MAX_DIFF and (sd > 0).mean() <= SOBEL_MAX_FRACTION,
            f"sobel L2 vs numpy oracle: maxdiff {sd.max()}")
    print(f"oracle 24x31x3 level 2: gaussian exact, box exact, sobel maxdiff {sd.max()}")

    # -- 4. main path at full size ----------------------------------------
    h, w, c = FULL
    image = rng.integers(0, 256, size=FULL, dtype=np.uint8)
    calls = {
        "gaussian": lambda lv: api.gaussian_blur(
            image, MAIN_SIGMA, MAIN_GAUSS_RADIUS, lv, runtime=rt),
        "box": lambda lv: api.box_blur(image, MAIN_BOX_RADIUS, lv, runtime=rt),
        "sobel": lambda lv: api.sobel_edge_detection(image, lv, runtime=rt),
    }
    radius_of = {"gaussian": MAIN_GAUSS_RADIUS, "box": MAIN_BOX_RADIUS, "sobel": 3}

    torch.cuda.synchronize()
    LAUNCHES.clear()
    results = {(f, lv): calls[f](lv) for f in calls for lv in (1, 2)}
    all_levels = {f: rt.run_all_levels(f, image, sigma=MAIN_SIGMA,
                                       radius=radius_of[f]) for f in calls}
    torch.cuda.synchronize()
    launches = {name: LAUNCHES[name] for name in KERNELS}
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        require(n > 0, f"main path never launched {name}")

    for (f, lv), res in results.items():
        require(set(res) == {"image", "time_ms", "bandwidth_gbps", "fps"},
                f"{f} L{lv}: result keys {sorted(res)}")
        require(res["image"].shape == FULL and res["image"].dtype == np.uint8,
                f"{f} L{lv}: image {res['image'].shape} {res['image'].dtype}")
        require(all(res[k] > 0 and np.isfinite(res[k])
                    for k in ("time_ms", "bandwidth_gbps", "fps")),
                f"{f} L{lv}: metrics {res}")
        out, metrics = all_levels[f][lv]
        require(np.array_equal(out, res["image"]),
                f"{f} L{lv}: run_all_levels differs from the API call")
        require(metrics.time_ms > 0, f"{f} L{lv}: run_all_levels time_ms")
    for f in ("gaussian", "box"):
        require(np.array_equal(results[(f, 1)]["image"], results[(f, 2)]["image"]),
                f"{f}: level 2 differs from level 1")
    rows = torch.from_numpy(image.reshape(h, w * c)).to(dev)
    plain = sobel.sobel_rows_plain(rows, w, c).cpu().numpy().reshape(FULL)
    sd = np.abs(results[("sobel", 2)]["image"].astype(int) - plain)
    require(sd.max() <= SOBEL_MAX_DIFF and (sd > 0).mean() <= SOBEL_MAX_FRACTION,
            f"sobel L2 vs plain L2: maxdiff {sd.max()}")
    print(f"main path checks: result dicts ok, gaussian/box L2 == L1, "
          f"sobel L2 vs plain maxdiff {sd.max()} fraction {(sd > 0).mean():.2e}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in calls:
            calls[f](2)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_kernels = [e.key for e in events
                      if getattr(e, "device_time_total", 0) > 0]
    for name, spec in KERNELS.items():
        for sub in spec["profiler_names"]:
            hits = [k for k in device_kernels if sub in k]
            require(hits, f"profiler lists no device kernel named {sub}")
            print(f"profiler: {name} -> {hits[0]}")

    # -- 5. times -------------------------------------------------------------
    for (f, lv), res in results.items():
        print(f"[{card}] {f} L{lv} {w}x{h}x{c}: time_ms {res['time_ms']:.4f}, "
              f"bandwidth_gbps {res['bandwidth_gbps']:.2f}, fps {res['fps']:.1f}")
    # Request time: the host clock around a whole API call, copies to and
    # from the card included (the call returns a numpy image, so it has
    # waited for the device).  Least of 3.
    for f in calls:
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            calls[f](2)
            walls.append((time.perf_counter() - t0) * 1000.0)
        print(f"[{card}] {f} L2 {w}x{h}x{c}: API call wall {min(walls):.3f} ms "
              f"(host clock, copies included)")

    def event_ms(fn, iters=20) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    wts = weights_to_torch(gaussian_kernel_f32(MAIN_GAUSS_RADIUS, MAIN_SIGMA), dev)
    arms = {
        "gaussian_rows": (
            lambda: blur.gaussian_rows(rows, wts, MAIN_GAUSS_RADIUS, c),
            lambda: blur.gaussian_rows_plain(rows, wts, MAIN_GAUSS_RADIUS, c)),
        "box_rows": (
            lambda: blur.box_rows(rows, MAIN_BOX_RADIUS, c),
            lambda: blur.box_rows_plain(rows, MAIN_BOX_RADIUS, c)),
        "sobel_rows": (
            lambda: sobel.sobel_rows(rows, w, c),
            lambda: sobel.sobel_rows_plain(rows, w, c)),
    }
    times = {}
    for name, (kernel, plain_fn) in arms.items():
        # plain, kernel, kernel, plain: drift hits both arms alike.
        p1, k1, k2, p2 = (event_ms(plain_fn), event_ms(kernel),
                          event_ms(kernel), event_ms(plain_fn))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[{card}] {name} {w}x{h}x{c}: kernel {times[name][0]:.4f} ms "
              f"({k1:.4f}, {k2:.4f}), plain torch {times[name][1]:.4f} ms "
              f"({p1:.4f}, {p2:.4f})")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], "also_replaces": spec["also_replaces"],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, spec in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
