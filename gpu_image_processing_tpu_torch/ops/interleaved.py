"""Level-1 filters on (H, W*C) interleaved uint8 rows, in plain torch ops.

The serving boundary ships images as (H, W*C) uint8 rows: the HWC byte order
viewed 2-D.  On these rows

* a horizontal tap at pixel offset t is a lane offset of t*C (all channels
  shift together),
* clamp-to-edge replicates PIXELS: a lane's tap reads pixel
  clamp(p + t, 0, W - 1) in the same channel,
* Sobel computes one Rec.601 grey value per pixel from its channels.

Numerics are bit-identical to the CUDA naive kernels
(image_filters.cu:64-144,362-431,1152-1315): every output element sees the
same f32 operation sequence, each tap term multiplied, then added in tap
order.  Each torch op here is its own elementwise kernel, so no multiply and
add are contracted into one FMA; do not `torch.compile` this module, since
fusion could contract them and flip floor(x + 0.5) ties.  The same code runs
on the CPU and on a CUDA device.
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


def _conv_cols(x: torch.Tensor, weights: torch.Tensor, radius: int,
               channels: int) -> torch.Tensor:
    """Weighted horizontal pass on (H, W*C) f32, CUDA tap order."""
    wf = x.shape[-1]
    xp = _pad_pixels_lr(x, radius, channels)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i * channels : i * channels + wf] * weights[i]
        acc = term if acc is None else acc + term
    return acc


def _conv_rows(x: torch.Tensor, weights: torch.Tensor,
               radius: int) -> torch.Tensor:
    height = x.shape[-2]
    xp = _pad_rows_edge(x, radius)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + height, :] * weights[i]
        acc = term if acc is None else acc + term
    return acc


def _sum_cols(x: torch.Tensor, radius: int, channels: int) -> torch.Tensor:
    wf = x.shape[-1]
    xp = _pad_pixels_lr(x, radius, channels)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i * channels : i * channels + wf]
        acc = term if acc is None else acc + term
    return acc


def _sum_rows(x: torch.Tensor, radius: int) -> torch.Tensor:
    height = x.shape[-2]
    xp = _pad_rows_edge(x, radius)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + height, :]
        acc = term if acc is None else acc + term
    return acc


def gaussian_rows(rows_u8: torch.Tensor, weights: torch.Tensor, radius: int,
                  channels: int) -> torch.Tensor:
    """(H, W*C) u8 -> u8 separable Gaussian, level-1 numerics.

    `weights` is the (2r+1,) float32 table on the same device as the rows.
    """
    x = rows_u8.to(torch.float32)
    h = quantize_u8_f32(_conv_cols(x, weights, radius, channels))
    return quantize_u8(_conv_rows(h, weights, radius))


def box_rows(rows_u8: torch.Tensor, radius: int, channels: int) -> torch.Tensor:
    """(H, W*C) u8 -> u8 separable box blur: raw f32 window sums in tap
    order, each times the f32 reciprocal of the tap count."""
    inv = float(box_inv_taps_f32(radius))
    x = rows_u8.to(torch.float32)
    h = quantize_u8_f32(_sum_cols(x, radius, channels) * inv)
    return quantize_u8(_sum_rows(h, radius) * inv)


def sobel_rows(rows_u8: torch.Tensor, level: int, width: int,
               channels: int) -> torch.Tensor:
    """(H, W*C) u8 -> u8 Sobel edge map, zeroed 1-px border.

    Level 1 keeps grey in f32; level 2 quantizes it first
    (image_filters.cu:1444).  Grey ignores alpha; the magnitude is written
    to every channel, alpha included (image_filters.cu:1311-1313).
    """
    height = rows_u8.shape[-2]
    x = rows_u8.to(torch.float32).reshape(height, width, channels)
    if channels == 1:
        gray = x[..., 0]
    else:
        gray = _GRAY_R * x[..., 0] + _GRAY_G * x[..., 1] + _GRAY_B * x[..., 2]
    if level == 2:
        gray = quantize_u8_f32(gray)

    gp = _pad_rows_edge(_pad_pixels_lr(gray, 1, 1), 1)

    def tap(dy: int, dx: int) -> torch.Tensor:
        return gp[1 + dy : 1 + dy + height, 1 + dx : 1 + dx + width]

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

    row = torch.arange(height, device=x.device)[:, None]
    pix = torch.arange(width, device=x.device)[None, :]
    inside = (pix >= 1) & (pix <= width - 2) & (row >= 1) & (row <= height - 2)
    edge = torch.where(inside, mag, 0.0).to(torch.uint8)
    return edge[..., None].expand(height, width, channels).reshape(
        height, width * channels)
