"""Example: composing the filter models as an `nn.Sequential` on a tensor.

The JAX package fuses its models into one jitted program; here each filter
is an `nn.Module` over (H, W, C) uint8 tensors, so a caller chains them as
it chains any modules, on the image's own device (level 2: the rows
kernels on the card).

    python -m gpu_image_processing_tpu_torch.examples.compose_filters [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from ..models import BoxBlur, GaussianBlur, SobelEdgeDetection
from ..runtime.device import resolve


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)
    device = resolve(args.device)

    denoised_edges = nn.Sequential(
        GaussianBlur(sigma=2.0, radius=3, level=2),
        BoxBlur(radius=2, level=2),
        SobelEdgeDetection(level=2),
    ).to(device)

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    with torch.no_grad():
        out = denoised_edges(torch.from_numpy(img).to(device)).cpu().numpy()
    print(f"in {img.shape} on {device} -> out {out.shape}, edge pixels >64: "
          f"{(out[:, :, 0] > 64).mean():.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
