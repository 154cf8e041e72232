"""Time the level-2 kernels of one checkout of the port on the card.

Usage, from the root of the repository:

    python3 gpu_image_processing_tpu_torch/tools/kernel_times.py [--root DIR]

imports `gpu_image_processing_tpu_torch` from DIR (default: the checkout
this file lies in), builds its kernels, and times `gaussian_rows` (sigma 2,
r = 3), `box_rows` (r = 5) and `sobel_rows` on a seeded 2146x3239 RGB image
with CUDA events: the mean of 20 back-to-back launches, in 5 rounds.  It
prints one JSON line: the root, the card's name and power limit as
nvidia-smi gives them, and each kernel's round means in ms.

To compare two checkouts, run it on both in one machine session, in the
order A, B, B, A, so that drift of the card touches both alike.  It calls
only wrappers whose signatures every version of the port has kept.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FULL = (2146, 3239, 3)        # the README image (bench.py:34,50-52)
SEED = 1234
ITERS, ROUNDS = 20, 5


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="checkout whose package is timed")
    args = parser.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import numpy as np
    import torch

    from gpu_image_processing_tpu_torch.ops.cuda import blur, sobel
    from gpu_image_processing_tpu_torch.ops.weights import (
        gaussian_kernel_f32, weights_to_torch)

    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    if not blur.__file__.startswith(root):
        print(f"kernel_times: imported {blur.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    h, w, c = FULL
    image = np.random.default_rng(SEED).integers(0, 256, size=FULL, dtype=np.uint8)
    rows = torch.from_numpy(image.reshape(h, w * c)).to(dev)
    weights = weights_to_torch(gaussian_kernel_f32(3, 2.0), dev)
    kernels = {
        "gaussian_rows": lambda: blur.gaussian_rows(rows, weights, 3, c),
        "box_rows": lambda: blur.box_rows(rows, 5, c),
        "sobel_rows": lambda: sobel.sobel_rows(rows, w, c),
    }

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS

    for fn in kernels.values():   # build, load and warm
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in kernels}
    for _ in range(ROUNDS):
        for name, fn in kernels.items():
            times[name].append(event_ms(fn))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    print(json.dumps({"root": args.root, "card": card, "shape": list(FULL),
                      "ms": {name: {"mean": sum(t) / len(t), "rounds": t}
                             for name, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
