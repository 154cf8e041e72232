"""The registry of level-2 and level-4 (ADVANCED) implementations, and the
plain planar versions.

`register_all` installs the planar tier of `ops/cuda/api.py` under the JAX
package's six keys (ops/fused.py:95-122 there): "gaussian", "box" and
"sobel" at level 2, and "<name>_adv" at level 4.  There is no switch that
serves another tier in their place: on a CUDA tensor the kernels launch or
raise.

`gaussian_fused`, `box_fused` and `sobel_fused` are the same level-2
functions in plain torch ops on (C, H, W) planes, the JAX package's
XLA-fused tier; the tests hold the kernels' path against them.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import interleaved, ref
from .cuda import api as cuda_api


def gaussian_fused(img_hwc: torch.Tensor, weights: torch.Tensor,
                   radius: int) -> torch.Tensor:
    planes = cuda_api.to_planes(img_hwc)
    return cuda_api.from_planes(
        interleaved.gaussian_rows(planes, weights, radius, 1))


def box_fused(img_hwc: torch.Tensor, radius: int) -> torch.Tensor:
    planes = cuda_api.to_planes(img_hwc)
    return cuda_api.from_planes(interleaved.box_rows(planes, radius, 1))


def sobel_fused(img_hwc: torch.Tensor) -> torch.Tensor:
    return ref.sobel(img_hwc, level=2)


def register_all(register: Callable[[str, Callable], None]) -> None:
    """Install the level-2 ("gaussian", "box", "sobel") and level-4
    ("<name>_adv") implementations of (H, W, C) uint8 tensors."""
    impls = cuda_api.level2_impls()
    impls.update({f"{k}_adv": v for k, v in cuda_api.level4_impls().items()})
    for name, fn in impls.items():
        register(name, fn)
