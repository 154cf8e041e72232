"""The filters on (H, W*C) interleaved uint8 rows, in plain torch ops.

The serving boundary ships images as (H, W*C) uint8 rows: the HWC byte order
viewed 2-D.  Every function also takes a batch, (..., H, W*C): the leading
axes are images, and each clamps at its own edges.  On these rows

* a horizontal tap at pixel offset t is a lane offset of t*C (all channels
  shift together),
* clamp-to-edge replicates PIXELS: a lane's tap reads pixel
  clamp(p + t, 0, W - 1) in the same channel,
* Sobel computes one Rec.601 grey value per pixel from its channels.

Level 1 (`gaussian_rows`, `box_rows`, `sobel_rows`) is bit-identical to the
CUDA naive kernels (image_filters.cu:64-144,362-431,1152-1315): every output
element sees the same f32 operation sequence, each tap term multiplied,
then added in tap order.  `gaussian_rows_folded` and `gaussian_rows_band`
are the level-4 tiers' functions, each in its own fixed order: the folded
kernel matches it to the bit, the tensor-core band kernel sums in its own
order and is held to within 1 on at most 0.1% of bytes.  Each torch op
here is its own elementwise kernel, so no multiply and add are contracted
into one FMA; do not `torch.compile` this module, since fusion could
contract them and flip floor(x + 0.5) ties.  The same code runs on the CPU and on a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch

from .rounding import quantize_u8, quantize_u8_f32
from .weights import box_inv_taps_f32

# Rec.601 weights as float32 values (image_filters.cu:1236).
_GRAY_R = float(np.float32(0.299))
_GRAY_G = float(np.float32(0.587))
_GRAY_B = float(np.float32(0.114))


def _pad_pixels_lr(x: torch.Tensor, radius: int, channels: int) -> torch.Tensor:
    """Pixel-replicated clamp-to-edge padding of the last (W*C) axis."""
    width = x.shape[-1] // channels
    lane = torch.arange((width + 2 * radius) * channels, device=x.device)
    pix = torch.clamp(lane // channels - radius, 0, width - 1)
    return x.index_select(-1, pix * channels + lane % channels)


def _pad_rows_edge(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Row-replicated clamp-to-edge padding of the H axis."""
    height = x.shape[-2]
    row = torch.arange(-radius, height + radius, device=x.device)
    return x.index_select(-2, torch.clamp(row, 0, height - 1))


def _tap_cols(x: torch.Tensor, radius: int, channels: int) -> list[torch.Tensor]:
    """The 2r+1 horizontal taps of (..., H, W*C) rows as views, in tap
    order: tap t of lane l is pixel clamp(l / C + t - r, 0, W - 1)."""
    wf = x.shape[-1]
    xp = _pad_pixels_lr(x, radius, channels)
    return [xp[..., t * channels : t * channels + wf]
            for t in range(2 * radius + 1)]


def _tap_rows(x: torch.Tensor, radius: int,
              rows_prepadded: bool = False) -> list[torch.Tensor]:
    """The 2r+1 vertical taps of (..., H, W*C) rows as views, clamped at
    each image's own first and last row.

    rows_prepadded: `x` carries `radius` given halo rows above and below
    (H + 2r rows); the taps read them unclamped and cover the H rows
    between."""
    if rows_prepadded:
        height = x.shape[-2] - 2 * radius
        xp = x
    else:
        height = x.shape[-2]
        xp = _pad_rows_edge(x, radius)
    return [xp[..., t : t + height, :] for t in range(2 * radius + 1)]


def _weighted(taps: list[torch.Tensor], weights: torch.Tensor) -> torch.Tensor:
    """sum_t taps[t] * w[t], each product rounded, added in tap order."""
    acc = None
    for t, tap in enumerate(taps):
        term = tap * weights[t]
        acc = term if acc is None else acc + term
    return acc


def _folded(taps: list[torch.Tensor], weights: torch.Tensor) -> torch.Tensor:
    """Symmetric tap pairs (ops/pallas/blur.py:318-329): for t < r,
    (x[t] + x[2r-t]) * w[t] added in t order, then + x[r] * w[r]."""
    radius = len(taps) // 2
    acc = None
    for t in range(radius):
        term = (taps[t] + taps[2 * radius - t]) * weights[t]
        acc = term if acc is None else acc + term
    mid = taps[radius] * weights[radius]
    return mid if acc is None else acc + mid


def _summed(taps: list[torch.Tensor]) -> torch.Tensor:
    acc = taps[0]
    for tap in taps[1:]:
        acc = acc + tap
    return acc


def gaussian_rows(rows_u8: torch.Tensor, weights: torch.Tensor, radius: int,
                  channels: int, rows_prepadded: bool = False) -> torch.Tensor:
    """(..., H, W*C) u8 -> u8 separable Gaussian, level-1 numerics.

    `weights` is the (2r+1,) float32 table on the same device as the rows.
    rows_prepadded: the input has `radius` halo rows above and below, which
    the vertical pass reads unclamped; the output has H rows.
    """
    x = rows_u8.to(torch.float32)
    h = quantize_u8_f32(_weighted(_tap_cols(x, radius, channels), weights))
    return quantize_u8(_weighted(_tap_rows(h, radius, rows_prepadded), weights))


def gaussian_rows_folded(rows_u8: torch.Tensor, weights: torch.Tensor,
                         radius: int, channels: int,
                         rows_prepadded: bool = False) -> torch.Tensor:
    """(..., H, W*C) u8 -> u8 separable Gaussian with symmetric tap pairs:
    the level-4 tier at r < 3 (within 1 of level 2)."""
    x = rows_u8.to(torch.float32)
    h = quantize_u8_f32(_folded(_tap_cols(x, radius, channels), weights))
    return quantize_u8(_folded(_tap_rows(h, radius, rows_prepadded), weights))


def gaussian_rows_band(rows_u8: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor, radius: int,
                       channels: int) -> torch.Tensor:
    """(..., H, W*C) u8 -> u8 separable Gaussian with the weights split in
    two bf16 halves, the level-4 tier at r >= 3 (blur_mxu.py:168-187,
    247-251,271-282).

    `hi`, `lo` are the f32 tables of `weights.bf16_split`.  Each pass is
    sum_t x*hi[t] plus sum_t x*lo[t], each sum in tap order; every product
    of a u8 value and a bf16 weight is exact in f32.
    """
    x = rows_u8.to(torch.float32)
    cols = _tap_cols(x, radius, channels)
    h = quantize_u8_f32(_weighted(cols, hi) + _weighted(cols, lo))
    rows = _tap_rows(h, radius)
    return quantize_u8(_weighted(rows, hi) + _weighted(rows, lo))


def box_rows(rows_u8: torch.Tensor, radius: int, channels: int,
             rows_prepadded: bool = False) -> torch.Tensor:
    """(..., H, W*C) u8 -> u8 separable box blur: raw f32 window sums in tap
    order, each times the f32 reciprocal of the tap count."""
    inv = float(box_inv_taps_f32(radius))
    x = rows_u8.to(torch.float32)
    h = quantize_u8_f32(_summed(_tap_cols(x, radius, channels)) * inv)
    return quantize_u8(_summed(_tap_rows(h, radius, rows_prepadded)) * inv)


def grayscale(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The f32 grey value of f32 pixels whose channels lie on `axis`: the
    value itself for one channel, else Rec.601 in the reference's order
    `(0.299f*R + 0.587f*G) + 0.114f*B`, each product and sum rounded.
    Alpha is ignored."""
    if x.shape[axis] == 1:
        return x.select(axis, 0)
    r, g, b = (x.select(axis, c) for c in range(3))
    return _GRAY_R * r + _GRAY_G * g + _GRAY_B * b


def sobel_magnitude(gray: torch.Tensor, rows_prepadded: bool = False,
                    zero_rows: bool = True) -> torch.Tensor:
    """(..., H, W) f32 grey -> (..., H, W) u8 Sobel magnitude,
    floor(min(sqrt(gx^2 + gy^2), 255) + 0.5), with a zeroed 1-px border.

    Outside the image the grey rows read 0, as the TPU kernels' constant
    row pad does; with the border rows zeroed that is never seen.
    rows_prepadded: `gray` carries one given halo row above and below
    (H + 2 rows), read as they are.  zero_rows=False keeps the first and
    last rows (a row band of a larger image); the 1-px width border is
    always zeroed.
    """
    if rows_prepadded:
        height = gray.shape[-2] - 2
        gp = _pad_pixels_lr(gray, 1, 1)
    else:
        height = gray.shape[-2]
        gp = torch.nn.functional.pad(_pad_pixels_lr(gray, 1, 1), (0, 0, 1, 1))
    width = gray.shape[-1]

    def tap(dy: int, dx: int) -> torch.Tensor:
        return gp[..., 1 + dy : 1 + dy + height, 1 + dx : 1 + dx + width]

    gx = (
        -1.0 * tap(-1, -1) + 1.0 * tap(-1, 1)
        + -2.0 * tap(0, -1) + 2.0 * tap(0, 1)
        + -1.0 * tap(1, -1) + 1.0 * tap(1, 1)
    )
    gy = (
        -1.0 * tap(-1, -1) + -2.0 * tap(-1, 0) + -1.0 * tap(-1, 1)
        + 1.0 * tap(1, -1) + 2.0 * tap(1, 0) + 1.0 * tap(1, 1)
    )
    mag = torch.floor(
        torch.clamp(torch.sqrt(gx * gx + gy * gy), max=255.0) + 0.5)

    row = torch.arange(height, device=gray.device)[:, None]
    pix = torch.arange(width, device=gray.device)[None, :]
    inside = (pix >= 1) & (pix <= width - 2)
    if zero_rows:
        inside = inside & (row >= 1) & (row <= height - 2)
    return torch.where(inside, mag, 0.0).to(torch.uint8)


def sobel_rows(rows_u8: torch.Tensor, level: int, width: int,
               channels: int) -> torch.Tensor:
    """(..., H, W*C) u8 -> u8 Sobel edge map, a zeroed 1-px border on each
    image.

    Level 1 keeps grey in f32; level 2 quantizes it first
    (image_filters.cu:1444).  Grey ignores alpha; the magnitude is written
    to every channel, alpha included (image_filters.cu:1311-1313).
    """
    lead, height = rows_u8.shape[:-2], rows_u8.shape[-2]
    x = rows_u8.to(torch.float32).reshape(*lead, height, width, channels)
    gray = grayscale(x, -1)
    if level == 2:
        gray = quantize_u8_f32(gray)
    edge = sobel_magnitude(gray)
    return edge[..., None].expand(*lead, height, width, channels).reshape(
        *lead, height, width * channels)
