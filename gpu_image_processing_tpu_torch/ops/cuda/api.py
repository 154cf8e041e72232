"""The planar tier: the port's counterpart of `ops/pallas/api.py`.

Functions of one (H, W, C) uint8 tensor, for callers that hold an image as
a tensor and compose filters in their own code (models/filters.py), and of
a (B, H, W, C) batch.  Each permutes the image to contiguous (C, H, W)
planes (a batch to B*C planes), runs the hand-written kernels on the
planes, and permutes back, as the JAX package's planar wrappers do
(ops/pallas/blur.py:1100-1104).  The registries have the JAX package's keys
and call signatures: `fn(img_hwc, w, radius)`, `fn(img_hwc, radius)`,
`fn(img_hwc)`.

Routing, as the JAX package routes (ops/pallas/api.py:16-84), on the
radius alone:
* gaussian level 2: the fused planar blur, weighted taps;
* gaussian level 4: folded taps below `GAUSS_MXU_MIN_RADIUS`, the bf16
  hi + lo band (`gaussian_band_rows` on the planes, one channel) from it up;
* box, levels 2 and 4 (every route is exact): the fused planar blur while
  2r + 1 <= `MAX_KERNEL_TAPS`, the running-sum `box_rows` on the planes
  above;
* Sobel level 2: `sobel_planar`; level 4: `sobel_f32_planar` (f32 grey).

On CPU tensors every kernel wrapper serves its plain version; on CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...core.config import GAUSS_MXU_MIN_RADIUS, MAX_KERNEL_TAPS
from ..weights import bf16_split_tensor, weights_to_torch
from . import blur, blur_planar, sobel_planar


def to_planes(img_hwc: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> contiguous (C, H, W)."""
    return img_hwc.permute(2, 0, 1).contiguous()


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> contiguous (H, W, C)."""
    return planes.permute(1, 2, 0).contiguous()


def table(weights, device: torch.device) -> torch.Tensor:
    """A (2r+1,) float32 weight table as a tensor: a numpy table (such as
    the JAX model's `weights`) moves to `device` bit for bit, a tensor is
    taken as it is."""
    if isinstance(weights, np.ndarray):
        return weights_to_torch(weights, device)
    return weights


def gaussian_planes(planes: torch.Tensor, weights: torch.Tensor, radius: int,
                    level: int) -> torch.Tensor:
    """Gaussian blur of (N, H, W) planes at level 2 or 4 (routed as above)."""
    if level == 2:
        return blur_planar.gaussian_planar(planes, weights, radius)
    if radius < GAUSS_MXU_MIN_RADIUS:
        return blur_planar.gaussian_folded_planar(planes, weights, radius)
    hi, lo = bf16_split_tensor(weights)
    return blur.gaussian_band_rows(planes, hi, lo, radius, 1)


def box_planes(planes: torch.Tensor, radius: int) -> torch.Tensor:
    """Box blur of (N, H, W) planes, at levels 2 and 4 alike."""
    if 2 * radius + 1 <= MAX_KERNEL_TAPS:
        return blur_planar.box_planar(planes, radius)
    return blur.box_rows(planes, radius, 1)


def _sobel(level: int) -> Callable[[torch.Tensor], torch.Tensor]:
    return sobel_planar.sobel_planar if level == 2 else sobel_planar.sobel_f32_planar


def level2_impls() -> dict[str, Callable]:
    """The level-2 functions of (H, W, C) uint8 tensors."""
    return {
        "gaussian": lambda img, w, radius: from_planes(gaussian_planes(
            to_planes(img), table(w, img.device), radius, 2)),
        "box": lambda img, radius: from_planes(
            box_planes(to_planes(img), radius)),
        "sobel": lambda img: from_planes(_sobel(2)(to_planes(img))),
    }


def level4_impls() -> dict[str, Callable]:
    """The ADVANCED (level-4) functions: within 1 of level 2."""
    return {
        "gaussian": lambda img, w, radius: from_planes(gaussian_planes(
            to_planes(img), table(w, img.device), radius, 4)),
        "box": lambda img, radius: from_planes(
            box_planes(to_planes(img), radius)),
        "sobel": lambda img: from_planes(_sobel(4)(to_planes(img))),
    }


def _batch_planes(imgs_bhwc: torch.Tensor) -> torch.Tensor:
    b, h, w, c = imgs_bhwc.shape
    return imgs_bhwc.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()


def _batch_hwc(planes: torch.Tensor, b: int, c: int) -> torch.Tensor:
    _, h, w = planes.shape
    return planes.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()


def gaussian_planar_batch(imgs_bhwc: torch.Tensor, weights, radius: int,
                          folded: bool = False) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8: the fused planar gaussian over all B*C planes
    in one launch (blur.py:1055-1072); `folded` is the level-4 tap order."""
    b, _, _, c = imgs_bhwc.shape
    fn = (blur_planar.gaussian_folded_planar if folded
          else blur_planar.gaussian_planar)
    out = fn(_batch_planes(imgs_bhwc), table(weights, imgs_bhwc.device), radius)
    return _batch_hwc(out, b, c)


def box_planar_batch(imgs_bhwc: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8: the box blur over all B*C planes in one launch
    (blur.py:1075-1087)."""
    b, _, _, c = imgs_bhwc.shape
    return _batch_hwc(box_planes(_batch_planes(imgs_bhwc), radius), b, c)


def sobel_planar_batch(imgs_bhwc: torch.Tensor, level: int = 2,
                       rows_prepadded: bool = False,
                       zero_rows: bool = True) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8 Sobel of a batch in one launch
    (sobel.py:395-470).  rows_prepadded: the input is (B, H + 2, W, C) with
    one given halo row above and below; zero_rows=False leaves the first
    and last rows to the caller."""
    planes = imgs_bhwc.permute(0, 3, 1, 2).contiguous()
    out = _sobel(level)(planes, rows_prepadded, zero_rows)
    return out.permute(0, 2, 3, 1).contiguous()
