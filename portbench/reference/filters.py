"""The plain filters: the upstream CUDA kernels' semantics in plain torch.

A frozen restatement of `tests/oracle_numpy.py` (itself transcribed from
upstream `cuda_lib/src/image_filters.cu`), written as whole-array torch
operations so that it runs on the card as well as on the CPU:

* gaussian: taps from `gaussian_table` (float32 throughout, as
  `generateGaussianKernel`, image_filters.cu:25-48), a horizontal then a
  vertical pass, each tap's product then its sum in tap order,
  clamp-to-edge, each pass rounded to uint8 by floor(x + 0.5);
* box: the raw sum of the 2r + 1 taps times the float32 1/(2r + 1), each
  pass rounded the same way;
* Sobel: the Rec.601 grey value (0.299 R + 0.587 G) + 0.114 B in float32,
  rounded to an integer first at level 2, the 3x3 gradients in the
  oracle's tap order, min(sqrt(gx^2 + gy^2), 255) rounded, a zeroed 1-pixel
  border, the value written to every channel.

Every operation is its own torch call, so no multiply and add are fused.
`dtype` is the precision the arithmetic runs in: float32 is the reference;
bfloat16 is the control, the step below the configuration's float32,
which the comparison has to refuse.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32
_GREY = (float(F32(0.299)), float(F32(0.587)), float(F32(0.114)))


def gaussian_table(radius: int, sigma: float) -> np.ndarray:
    """The (2r + 1,) float32 taps: exp(-(x*x) / (2 sigma sigma)) for
    x = -r..r, summed in that order, each divided by the sum."""
    denom = F32(2.0) * F32(sigma) * F32(sigma)
    vals = [F32(np.exp(F32(-(F32(i) * F32(i))) / denom))
            for i in range(-radius, radius + 1)]
    total = F32(0.0)
    for v in vals:
        total = F32(total + v)
    return np.array([F32(v / total) for v in vals], np.float32)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5).clamp(0, 255).to(torch.uint8)


def _taps(x: torch.Tensor, radius: int, dim: int):
    """The 2r + 1 clamp-to-edge neighbours of `x` along `dim`, in tap
    order."""
    n = x.shape[dim]
    base = torch.arange(n, device=x.device)
    for off in range(-radius, radius + 1):
        yield x.index_select(dim, (base + off).clamp(0, n - 1))


def _gaussian_pass(x: torch.Tensor, weights: list[float], radius: int,
                   dim: int, dtype: torch.dtype) -> torch.Tensor:
    acc = torch.zeros(x.shape, dtype=dtype, device=x.device)
    for w, nb in zip(weights, _taps(x.to(dtype), radius, dim)):
        acc = acc + nb * torch.tensor(w, dtype=dtype, device=x.device)
    return _round_u8(acc)


def gaussian(img: torch.Tensor, sigma: float, radius: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, C) uint8 -> uint8 gaussian blur."""
    weights = [float(w) for w in gaussian_table(radius, sigma)]
    h = _gaussian_pass(img, weights, radius, img.dim() - 2, dtype)
    return _gaussian_pass(h, weights, radius, img.dim() - 3, dtype)


def _box_pass(x: torch.Tensor, radius: int, dim: int,
              dtype: torch.dtype) -> torch.Tensor:
    acc = torch.zeros(x.shape, dtype=dtype, device=x.device)
    for nb in _taps(x.to(dtype), radius, dim):
        acc = acc + nb
    inv = torch.tensor(float(F32(1.0) / F32(2 * radius + 1)), dtype=dtype,
                       device=x.device)
    return _round_u8(acc * inv)


def box(img: torch.Tensor, radius: int,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, C) uint8 -> uint8 box blur."""
    h = _box_pass(img, radius, img.dim() - 2, dtype)
    return _box_pass(h, radius, img.dim() - 3, dtype)


def sobel(img: torch.Tensor, level: int,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, C) uint8 -> uint8 Sobel magnitude; level 2 rounds the
    grey value to an integer, levels 1 and 4 keep it."""
    x = img.to(dtype)
    if img.shape[-1] == 1:
        grey = x[..., 0]
    else:
        r, g, b = (torch.tensor(c, dtype=dtype, device=img.device)
                   for c in _GREY)
        grey = (x[..., 0] * r + x[..., 1] * g) + x[..., 2] * b
    if level == 2:
        grey = torch.floor(grey + 0.5).clamp(0, 255)
    p = grey
    h, w = p.shape[-2:]
    t = lambda dy, dx: p[..., 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]  # noqa: E731
    gx = -t(-1, -1)
    gx = gx + t(-1, 1)
    gx = gx + -2.0 * t(0, -1)
    gx = gx + 2.0 * t(0, 1)
    gx = gx + -t(1, -1)
    gx = gx + t(1, 1)
    gy = -t(-1, -1)
    gy = gy + -2.0 * t(-1, 0)
    gy = gy + -t(-1, 1)
    gy = gy + t(1, -1)
    gy = gy + 2.0 * t(1, 0)
    gy = gy + t(1, 1)
    mag = torch.sqrt(gx * gx + gy * gy).clamp(max=255.0)
    out = torch.zeros(p.shape, dtype=torch.uint8, device=img.device)
    out[..., 1:h - 1, 1:w - 1] = torch.floor(mag + 0.5).to(torch.uint8)
    return out[..., None].expand(img.shape).contiguous()


def apply(img: torch.Tensor, filter_name: str, level: int, sigma: float,
          radius: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The function the program is held to for one call.  Levels 2 and 4
    of the blurs are held to the level-1 function: level 2 is stated
    exact, level 4 within one of it (`check.py`)."""
    if filter_name == "gaussian":
        return gaussian(img, sigma, radius, dtype)
    if filter_name == "box":
        return box(img, radius, dtype)
    return sobel(img, 2 if level == 2 else 1, dtype)
