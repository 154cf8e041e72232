"""Gaussian weight generation, bit-matched to the CUDA host helper.

`generateGaussianKernel` (cuda_lib/src/image_filters.cu:25-48) computes, in
float32 throughout:

    value[i] = expf(-(x*x) / (2.0f * sigma * sigma)),  x = float(i), i=-r..r
    sum      = sequential accumulation over i = -r..r
    kernel[i] /= sum

We replicate the same float32 operation order with numpy so the weight table
is bit-identical (modulo at most 1 ulp in expf) to the one the CUDA kernels
consume.  The table is built on the host and moved to the device with
`weights_to_torch`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def gaussian_kernel_f32(radius: int, sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps, shape (2*radius+1,), float32."""
    sigma32 = np.float32(sigma)
    two = np.float32(2.0)
    denom = two * sigma32 * sigma32  # matches `2.0f * sigma * sigma`
    vals = []
    total = np.float32(0.0)
    for i in range(-radius, radius + 1):
        x = np.float32(i)
        v = np.float32(np.exp(np.float32(-(x * x)) / denom))
        vals.append(v)
        total = np.float32(total + v)
    out = np.array([np.float32(v / total) for v in vals], dtype=np.float32)
    out.setflags(write=False)
    return out


def box_inv_taps_f32(radius: int) -> np.float32:
    """The f32 reciprocal the box passes multiply their raw sums by."""
    return np.float32(1.0) / np.float32(2 * radius + 1)


def bf16_split(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) float32 tables with hi = bf16(w) and lo = bf16(w - hi),
    both rounded to nearest even (blur_mxu.py:168-187): the weight split of
    the level-4 band tier.  Every value is an exact bf16, so its product
    with a u8 pixel is exact in f32."""
    hi, lo = bf16_split_tensor(torch.tensor(np.asarray(weights, dtype=np.float32)))
    return hi.numpy(), lo.numpy()


def bf16_split_tensor(weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`bf16_split` of a float32 tensor, on the tensor's own device (torch
    rounds float32 to bfloat16 to nearest even on the CPU and the card)."""
    hi = weights.to(torch.bfloat16).to(torch.float32)
    lo = (weights - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def weights_to_torch(weights: np.ndarray, device: torch.device) -> torch.Tensor:
    """A (2r+1,) float32 weight table as a contiguous tensor on `device`.

    Takes any table of that form, including the JAX package's own
    `gaussian_kernel_f32`, and keeps its float32 bits unchanged.
    """
    table = np.asarray(weights)
    if table.dtype != np.float32 or table.ndim != 1 or table.size % 2 != 1:
        raise ValueError(
            f"weights must be a (2r+1,) float32 table; got {table.dtype} "
            f"{table.shape}")
    return torch.tensor(table, dtype=torch.float32, device=device)
