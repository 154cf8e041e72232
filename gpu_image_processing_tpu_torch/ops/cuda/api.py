"""The planar tier: the port's counterpart of `ops/pallas/api.py`.

Functions of one (H, W, C) uint8 tensor, for callers that hold an image as
a tensor and compose filters in their own code (models/filters.py), and of
a (B, H, W, C) batch.  The JAX package permutes each image to (C, H, W)
planes and back around its planar kernels (ops/pallas/blur.py:1100-1104).
Here a contiguous (H, W, C) image already is (H, W*C) interleaved rows, and
a (B, H, W, C) batch (B, H, W*C) rows, so the tier runs the rows kernels on
that view, with no permute.  The registries have the JAX package's keys and
call signatures: `fn(img_hwc, w, radius)`, `fn(img_hwc, radius)`,
`fn(img_hwc)`.

Routing, as the JAX package routes (ops/pallas/api.py:16-84), on the
radius alone:
* gaussian level 2: `gaussian_rows`;
* gaussian level 4: `gaussian_folded_rows` below `GAUSS_MXU_MIN_RADIUS`,
  the bf16 hi + lo band from it up (`gaussian_band_rows` on the (C, H, W)
  planes, one channel, where it beats the rows form at wide radii);
* box, levels 2 and 4 (every route is exact): `box_rows`;
* Sobel level 2: `sobel_rows`; level 4: `sobel_f32_rows` (f32 grey).
An image with more channels than a rows kernel takes (`blur.GAUSS_MAX_CHANNELS`,
`blur.BOX_MAX_CHANNELS`) runs on its planes, one channel a plane, through
the planar blur (K5, r <= 31; wider box radii through `box_rows` at one
channel).  `sobel_planar_batch` with halo rows or `zero_rows=False` runs the
planar Sobel (K6/K7) on planes.

The gaussian kernels take their taps by value: a table on the card is read
back, which waits for the card, so callers pass it on the host (`table`).
On CPU tensors every kernel wrapper serves its plain version; on CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...core.config import GAUSS_MXU_MIN_RADIUS, MAX_KERNEL_TAPS
from ..weights import bf16_split_tensor, weights_to_torch
from . import blur, blur_planar, sobel, sobel_planar


def to_planes(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> contiguous (..., C, H, W)."""
    d = img.dim()
    return img.permute(*range(d - 3), d - 1, d - 3, d - 2).contiguous()


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> contiguous (..., H, W, C)."""
    d = planes.dim()
    return planes.permute(*range(d - 3), d - 2, d - 1, d - 3).contiguous()


def table(weights) -> torch.Tensor:
    """A (2r+1,) float32 weight table as a tensor: a numpy table (such as
    the JAX model's `weights`) becomes a host tensor bit for bit, a tensor
    is taken as it is."""
    if isinstance(weights, np.ndarray):
        return weights_to_torch(weights, torch.device("cpu"))
    return weights


def _on_rows(img: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]
             ) -> torch.Tensor:
    """`fn` of (..., H, W*C) rows on the (..., H, W, C) image(s) `img`."""
    x = img.contiguous()
    *lead, h, w, c = x.shape
    return fn(x.view(*lead, h, w * c)).view(x.shape)


def _on_planes(img: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """`fn` of (N, H, W) planes on every channel plane of the (..., H, W, C)
    image(s) `img`."""
    planes = to_planes(img)
    out = fn(planes.view(-1, *planes.shape[-2:]))
    return from_planes(out.view(planes.shape))


def _gaussian_taps(img: torch.Tensor, weights: torch.Tensor, radius: int,
                   folded: bool) -> torch.Tensor:
    """The gaussian with weighted (level 2) or folded (level 4) taps."""
    c = img.shape[-1]
    if c <= blur.GAUSS_MAX_CHANNELS:
        fn = blur.gaussian_folded_rows if folded else blur.gaussian_rows
        return _on_rows(img, lambda x: fn(x, weights, radius, c))
    fn = (blur_planar.gaussian_folded_planar if folded
          else blur_planar.gaussian_planar)
    return _on_planes(img, lambda p: fn(p, weights, radius))


def gaussian(img: torch.Tensor, weights, radius: int,
             level: int) -> torch.Tensor:
    """Gaussian blur of (..., H, W, C) image(s) at level 2 or 4."""
    w = table(weights)
    if level == 4 and radius >= GAUSS_MXU_MIN_RADIUS:
        hi, lo = (t.to(img.device) for t in bf16_split_tensor(w))
        return _on_planes(img, lambda p: blur.gaussian_band_rows(
            p, hi, lo, radius, 1))
    return _gaussian_taps(img, w, radius, level == 4)


def box_planes(planes: torch.Tensor, radius: int) -> torch.Tensor:
    """Box blur of (N, H, W) planes, at levels 2 and 4 alike."""
    if 2 * radius + 1 <= MAX_KERNEL_TAPS:
        return blur_planar.box_planar(planes, radius)
    return blur.box_rows(planes, radius, 1)


def box(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Box blur of (..., H, W, C) image(s), at levels 2 and 4 alike."""
    c = img.shape[-1]
    if c <= blur.BOX_MAX_CHANNELS:
        return _on_rows(img, lambda x: blur.box_rows(x, radius, c))
    return _on_planes(img, lambda p: box_planes(p, radius))


def edges(img: torch.Tensor, level: int) -> torch.Tensor:
    """Sobel edge map of (..., H, W, C) image(s): level 2 quantizes the
    grey value, levels 1 and 4 keep it in f32."""
    w, c = img.shape[-2:]
    fn = sobel.sobel_rows if level == 2 else sobel.sobel_f32_rows
    return _on_rows(img, lambda x: fn(x, w, c))


def level2_impls() -> dict[str, Callable]:
    """The level-2 functions of (H, W, C) uint8 tensors."""
    return {
        "gaussian": lambda img, w, radius: gaussian(img, w, radius, 2),
        "box": box,
        "sobel": lambda img: edges(img, 2),
    }


def level4_impls() -> dict[str, Callable]:
    """The ADVANCED (level-4) functions: within 1 of level 2."""
    return {
        "gaussian": lambda img, w, radius: gaussian(img, w, radius, 4),
        "box": box,
        "sobel": lambda img: edges(img, 4),
    }


def gaussian_planar_batch(imgs_bhwc: torch.Tensor, weights, radius: int,
                          folded: bool = False) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8: the gaussian over the batch in one launch
    (blur.py:1055-1072); `folded` is the level-4 tap order."""
    return _gaussian_taps(imgs_bhwc, table(weights), radius, folded)


def box_planar_batch(imgs_bhwc: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8: the box blur over the batch in one launch
    (blur.py:1075-1087)."""
    return box(imgs_bhwc, radius)


def sobel_planar_batch(imgs_bhwc: torch.Tensor, level: int = 2,
                       rows_prepadded: bool = False,
                       zero_rows: bool = True) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8 Sobel of a batch in one launch
    (sobel.py:395-470).  rows_prepadded: the input is (B, H + 2, W, C) with
    one given halo row above and below; zero_rows=False leaves the first
    and last rows to the caller.  Those two modes run on planes."""
    if not rows_prepadded and zero_rows:
        return edges(imgs_bhwc, level)
    fn = sobel_planar.sobel_planar if level == 2 else sobel_planar.sobel_f32_planar
    return from_planes(fn(to_planes(imgs_bhwc), rows_prepadded, zero_rows))
