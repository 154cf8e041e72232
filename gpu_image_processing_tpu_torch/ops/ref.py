"""Level-1 filters on (H, W, C) uint8 tensors, or (..., H, W, C) stacks of
them: the reference numerics.

The counterparts of the JAX package's `ops/ref.py` (:82-172), for callers
that hold an image as a tensor.  An (H, W, C) image viewed as (H, W*C) rows
is the same bytes, and `ops/interleaved.py` computes the same function on
those rows to the bit (each tap multiplied, then added in tap order; every
pass quantized with floor(x + 0.5)), so each function here is a view and a
call.  Plain torch ops, on the tensor's own device.
"""

from __future__ import annotations

import torch

from . import interleaved
from .rounding import quantize_u8_f32


def _rows(img_hwc: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H, W*C): each leading index is an image."""
    return img_hwc.reshape(*img_hwc.shape[:-2], -1)


def gaussian_blur(img_hwc: torch.Tensor, weights: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """Separable Gaussian blur, level-1 numerics. (..., H, W, C) u8 -> u8."""
    out = interleaved.gaussian_rows(_rows(img_hwc), weights, radius,
                                    img_hwc.shape[-1])
    return out.reshape(img_hwc.shape)


def box_blur(img_hwc: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box blur, level-1 numerics. (..., H, W, C) u8 -> u8."""
    out = interleaved.box_rows(_rows(img_hwc), radius, img_hwc.shape[-1])
    return out.reshape(img_hwc.shape)


def grayscale_f32(img_hwc: torch.Tensor) -> torch.Tensor:
    """(H, W, C) u8 -> (H, W) f32 grey plane: the plane itself for C = 1,
    else `(0.299f*R + 0.587f*G) + 0.114f*B`; alpha is ignored."""
    return interleaved.grayscale(img_hwc.to(torch.float32), -1)


def sobel_magnitude_u8(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) f32 grey -> (H, W) u8 edge magnitude with a zeroed 1-px
    border."""
    return interleaved.sobel_magnitude(gray)


def sobel(img_hwc: torch.Tensor, level: int) -> torch.Tensor:
    """Sobel edge detection. (..., H, W, C) u8 -> (..., H, W, C) u8.

    Level 1 keeps the grey value in f32; level 2 quantizes it to uint8
    first.  The edge value goes to every channel, alpha included.
    """
    gray = grayscale_f32(img_hwc)
    if level == 2:
        gray = quantize_u8_f32(gray)
    edge = sobel_magnitude_u8(gray)
    return edge[..., None].expand(img_hwc.shape).contiguous()
