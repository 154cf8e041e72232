"""Time the rows blur and Sobel kernels of one or two checkouts on the card.

Usage, from the root of the repository:

    python3 gpu_image_processing_tpu_torch/tools/kernel_times.py \
        [--root DIR] [--ref DIR]

imports `gpu_image_processing_tpu_torch` from DIR (default: the checkout
this file lies in), builds its kernels, and times each case below on a
seeded 2146x3239 RGB image with CUDA events: the mean of ITERS back-to-back
launches.  The cases: `gaussian_rows` (sigma 2, r = 3), `box_rows` at
r = 1, 5, 15, 40 and 4000 (wider than the image), `sobel_rows`, and
`gaussian_band_rows` at r = 3, 15, 31 on the (H, W*C) rows and on the
(3, H, W) planes of the same image.

With --ref, it also imports the package of a second checkout, REF, under
another module name (the package imports itself only relatively), so that
both are timed in one process on one card, in the order REF, ROOT, ROOT,
REF for every case: drift of the card touches both alike.  It calls only
wrappers whose signatures every version of the port has kept.

It prints one line per case and, last, one JSON line: the card's name and
power limit as nvidia-smi gives them, the roots, and each case's times in
ms.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

FULL = (2146, 3239, 3)        # the README image (bench.py:34,50-52)
SEED = 1234
ITERS = 20
PACKAGE = "gpu_image_processing_tpu_torch"
BOX_RADII = (1, 5, 15, 40, 4000)
BAND = ((3, 2.0), (15, 5.0), (31, 8.0))     # (radius, sigma)


def load_package(root: str, name: str):
    """(blur, sobel, weights) modules of the package under `root`, imported
    as the package `name`."""
    if name == PACKAGE:
        sys.path.insert(0, root)
    else:
        pkg = Path(root) / PACKAGE
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    mods = [importlib.import_module(f"{name}.{m}")
            for m in ("ops.cuda.blur", "ops.cuda.sobel", "ops.weights")]
    if not mods[0].__file__.startswith(str(Path(root).resolve())):
        raise RuntimeError(f"imported {mods[0].__file__}, not from {root}")
    return mods


def cases(blur, sobel, weights, rows, planes, width: int, channels: int) -> dict:
    """name -> zero-argument launch of one checkout's kernel."""
    dev = rows.device
    w3 = weights.weights_to_torch(weights.gaussian_kernel_f32(3, 2.0), dev)
    out = {
        "gaussian_rows r=3": lambda: blur.gaussian_rows(rows, w3, 3, channels),
        "sobel_rows": lambda: sobel.sobel_rows(rows, width, channels),
    }
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

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS

    for arm in arms.values():   # build, load and warm
        for fn in arm.values():
            fn()
    torch.cuda.synchronize()
    order = ["ref", "root", "root", "ref"] if "ref" in arms else ["root"] * 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    times = {}
    for name in arms["root"]:
        got = {arm: [] for arm in arms}
        for arm in order:
            got[arm].append(event_ms(arms[arm][name]))
        times[name] = got
        line = "; ".join(f"{arm} " + ", ".join(f"{t:.4f}" for t in ts)
                         for arm, ts in got.items())
        ratio = ""
        if "ref" in got:
            ratio = f"; root / ref {sum(got['root']) / sum(got['ref']):.3f}"
        print(f"[{card}] {name} {h}x{w}x{c}: {line} ms{ratio}", flush=True)
    print(json.dumps({"card": card, "shape": list(FULL), "roots": roots,
                      "order": order, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
