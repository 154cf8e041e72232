"""The route from a filter call to its kernel, and the planar tier: the
port's counterpart of `ops/pallas/api.py`.

`rows_function` picks the function of (..., H, W*C) rows that serves a
(filter, level, radius) for every caller: the runtime, the modules, the
batch filter and the tier below; the profiler's model asks `uses_band`.
The rule, as the JAX package routes (ops/pallas/api.py:16-84), on the
radius alone:
* level 1: the plain torch ops of `ops/interleaved.py`;
* gaussian level 2: `blur.gaussian_rows`; level 4: `gaussian_folded_rows`
  below `GAUSS_MXU_MIN_RADIUS`, the bf16 hi + lo band on the tensor cores
  (`gaussian_band_rows`) from it up;
* box, levels 2 and 4 (every route is exact): `blur.box_rows`;
* Sobel level 2: `sobel.sobel_rows`; level 4: `sobel_f32_rows` (f32 grey).
The kernels take the gaussian's taps by value: a table on the card is read
back, which waits for the card, so callers pass it on the host.  On CPU
tensors every kernel wrapper serves its plain version; on CUDA tensors
they launch the kernels or raise.

The tier (`filtered`): functions of (H, W, C) uint8 tensors and (B, H, W,
C) batches.  The JAX package permutes each image to (C, H, W) planes and
back around its planar kernels (ops/pallas/blur.py:1100-1104).  Here a
contiguous image already is (H, W*C) interleaved rows, so the tier runs
the rows function on that view, with no permute, but for two choices of
layout: the level-4 band runs on the planes, one channel, where it beats
the rows form at wide radii; and a blur of more channels than its rows
kernel takes (`blur.GAUSS_MAX_CHANNELS`, `blur.BOX_MAX_CHANNELS`) runs on
its planes through the planar blur (K5, r <= 31; wider box radii through
`box_rows` at one channel).  `sobel_planar_batch` with halo rows or
`zero_rows=False` runs the planar Sobel (K6/K7) on planes.  The registries
have the JAX package's keys and call signatures: `fn(img_hwc, w, radius)`,
`fn(img_hwc, radius)`, `fn(img_hwc)`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...core.config import GAUSS_MXU_MIN_RADIUS, MAX_KERNEL_TAPS
from .. import interleaved
from ..weights import bf16_split_tensor, weights_to_torch
from . import blur, blur_planar, sobel, sobel_planar

RowsFn = Callable[[torch.Tensor], torch.Tensor]

#: The most channels a blur's rows kernel takes: more run on planes (K5).
_ROWS_MAX_CHANNELS = {"gaussian": blur.GAUSS_MAX_CHANNELS,
                      "box": blur.BOX_MAX_CHANNELS}


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


def _on_rows(img: torch.Tensor, fn: RowsFn) -> torch.Tensor:
    """`fn` of (..., H, W*C) rows on the (..., H, W, C) image(s) `img`."""
    x = img.contiguous()
    *lead, h, w, c = x.shape
    return fn(x.view(*lead, h, w * c)).view(x.shape)


def _on_planes(img: torch.Tensor, fn: RowsFn) -> torch.Tensor:
    """`fn` of (N, H, W) planes on every channel plane of the (..., H, W, C)
    image(s) `img`."""
    planes = to_planes(img)
    out = fn(planes.view(-1, *planes.shape[-2:]))
    return from_planes(out.view(planes.shape))


def uses_band(filter_name: str, level: int, radius: int) -> bool:
    """Whether `rows_function` serves the call with the bf16 hi + lo band on
    the tensor cores: the level-4 gaussian from `GAUSS_MXU_MIN_RADIUS` up."""
    return (filter_name == "gaussian" and level == 4
            and radius >= GAUSS_MXU_MIN_RADIUS)


def rows_function(filter_name: str, level: int, radius: int, channels: int,
                  width: int, weights, device: torch.device) -> RowsFn:
    """The function of contiguous (..., H, W*C) uint8 rows on `device` that
    serves `filter_name` at the canonical `level` (1, 2 or 4), by the rule
    above.  `weights`: the gaussian's (2r+1,) float32 table, numpy or a
    tensor, taken as it is below the band; level 1 and the band's hi + lo
    put it on `device` here, so that the function copies no table."""
    return _route(filter_name, level, radius, channels, width, weights,
                  device, uses_band(filter_name, level, radius))


def _route(filter_name: str, level: int, radius: int, channels: int,
           width: int, weights, device: torch.device, band: bool) -> RowsFn:
    """`rows_function` with the band decided by the caller: the level-4
    gaussian without it is folded taps at every radius."""
    if filter_name == "gaussian":
        w = table(weights)
        if band:
            hi, lo = (t.to(device) for t in bf16_split_tensor(w))
            fn = blur.gaussian_band_rows
            return lambda rows: fn(rows, hi, lo, radius, channels)
        if level == 1:
            w, fn = w.to(device), interleaved.gaussian_rows
        else:
            fn = blur.gaussian_folded_rows if level == 4 else blur.gaussian_rows
        return lambda rows: fn(rows, w, radius, channels)
    if filter_name == "box":
        fn = interleaved.box_rows if level == 1 else blur.box_rows
        return lambda rows: fn(rows, radius, channels)
    if level == 1:
        fn = interleaved.sobel_rows
        return lambda rows: fn(rows, 1, width, channels)
    fn = sobel.sobel_rows if level == 2 else sobel.sobel_f32_rows
    return lambda rows: fn(rows, width, channels)


def _planar_blur(filter_name: str, level: int, radius: int,
                 weights: torch.Tensor | None) -> RowsFn:
    """The planar blur's function of (N, H, W) planes (K5); a box past its
    cap (2r + 1 <= MAX_KERNEL_TAPS) runs `box_rows` at one channel."""
    if filter_name == "gaussian":
        fn = (blur_planar.gaussian_folded_planar if level == 4
              else blur_planar.gaussian_planar)
        return lambda planes: fn(planes, weights, radius)
    if 2 * radius + 1 <= MAX_KERNEL_TAPS:
        return lambda planes: blur_planar.box_planar(planes, radius)
    return lambda planes: blur.box_rows(planes, radius, 1)


def filtered(img: torch.Tensor, filter_name: str, level: int, radius: int = 0,
             weights=None) -> torch.Tensor:
    """`filter_name` of (..., H, W, C) uint8 image(s) at `level` (1, 2 or
    4), in the tier's layout (above); `weights` is the gaussian's table."""
    return _filtered(img, filter_name, level, radius, weights,
                     uses_band(filter_name, level, radius))


def _filtered(img: torch.Tensor, filter_name: str, level: int, radius: int,
              weights, band: bool) -> torch.Tensor:
    width, c = img.shape[-2:]
    if band:
        return _on_planes(img, _route(filter_name, level, radius, 1, width,
                                      weights, img.device, True))
    if level != 1 and c > _ROWS_MAX_CHANNELS.get(filter_name, c):
        return _on_planes(img, _planar_blur(filter_name, level, radius,
                                            table(weights)))
    return _on_rows(img, _route(filter_name, level, radius, c, width, weights,
                                img.device, False))


def level2_impls() -> dict[str, Callable]:
    """The level-2 functions of (H, W, C) uint8 tensors."""
    return {
        "gaussian": lambda img, w, radius: filtered(img, "gaussian", 2,
                                                    radius, w),
        "box": lambda img, radius: filtered(img, "box", 2, radius),
        "sobel": lambda img: filtered(img, "sobel", 2),
    }


def level4_impls() -> dict[str, Callable]:
    """The ADVANCED (level-4) functions: within 1 of level 2."""
    return {
        "gaussian": lambda img, w, radius: filtered(img, "gaussian", 4,
                                                    radius, w),
        "box": lambda img, radius: filtered(img, "box", 4, radius),
        "sobel": lambda img: filtered(img, "sobel", 4),
    }


def gaussian_planar_batch(imgs_bhwc: torch.Tensor, weights, radius: int,
                          folded: bool = False) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8: the gaussian over the batch in one launch
    (blur.py:1055-1072); `folded` is the level-4 tap order, at every radius
    (the band is the level-4 route's choice, not this kernel's)."""
    return _filtered(imgs_bhwc, "gaussian", 4 if folded else 2, radius,
                     weights, False)


def box_planar_batch(imgs_bhwc: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8: the box blur over the batch in one launch
    (blur.py:1075-1087)."""
    return filtered(imgs_bhwc, "box", 2, radius)


def sobel_planar_batch(imgs_bhwc: torch.Tensor, level: int = 2,
                       rows_prepadded: bool = False,
                       zero_rows: bool = True) -> torch.Tensor:
    """(B, H, W, C) u8 -> u8 Sobel of a batch in one launch
    (sobel.py:395-470).  rows_prepadded: the input is (B, H + 2, W, C) with
    one given halo row above and below; zero_rows=False leaves the first
    and last rows to the caller.  Those two modes run on planes."""
    if not rows_prepadded and zero_rows:
        return filtered(imgs_bhwc, "sobel", 2 if level == 2 else 4)
    fn = sobel_planar.sobel_planar if level == 2 else sobel_planar.sobel_f32_planar
    return from_planes(fn(to_planes(imgs_bhwc), rows_prepadded, zero_rows))
