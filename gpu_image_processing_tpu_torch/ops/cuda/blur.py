"""The blur kernels of `blur.cu` and their plain torch versions.

`gaussian_rows` replaces the TPU kernel `ops/pallas/blur.py::_blur_kernel`;
`box_rows` replaces it in box mode and `ops/pallas/blur_mxu.py::
_gauss_mxu_kernel` in box mode.  Both take (H, W*C) uint8 rows.  On a CPU
tensor they return the plain version; on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import interleaved
from ..weights import box_inv_taps_f32
from . import LAUNCHES, build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gip_gaussian_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gip_box_rows": [_P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _P],
}


def gaussian_rows_plain(rows: torch.Tensor, weights: torch.Tensor,
                        radius: int, channels: int) -> torch.Tensor:
    """The kernel's function in plain torch ops (the level-1 numerics)."""
    return interleaved.gaussian_rows(rows, weights, radius, channels)


def box_rows_plain(rows: torch.Tensor, radius: int,
                   channels: int) -> torch.Tensor:
    """The kernel's function in plain torch ops (the level-1 numerics)."""
    return interleaved.box_rows(rows, radius, channels)


def check_rows(rows: torch.Tensor, channels: int) -> tuple[int, int]:
    """(height, width) of contiguous (H, W*C) uint8 rows; raises otherwise."""
    if rows.dtype != torch.uint8 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(
            f"expected contiguous (H, W*C) uint8 rows; got {rows.dtype} "
            f"{tuple(rows.shape)}")
    if channels < 1 or rows.shape[1] % channels:
        raise ValueError(
            f"row width {rows.shape[1]} is not a multiple of {channels} channels")
    return rows.shape[0], rows.shape[1] // channels


def _launch(fn_name: str, rows: torch.Tensor, *args) -> torch.Tensor:
    lib = build.load("blur", rows.device, _SIGNATURES)
    tmp = torch.empty_like(rows)
    out = torch.empty_like(rows)
    with torch.cuda.device(rows.device):
        code = getattr(lib, fn_name)(
            rows.data_ptr(), tmp.data_ptr(), out.data_ptr(), *args,
            build.stream_handle(rows.device))
    build.check(lib, code, fn_name)
    return out


def gaussian_rows(rows: torch.Tensor, weights: torch.Tensor, radius: int,
                  channels: int) -> torch.Tensor:
    """Separable gaussian blur of (H, W*C) uint8 rows, level-2 numerics.

    `weights` is the (2r+1,) float32 table on the same device as `rows`.
    """
    if rows.device.type == "cpu":
        return gaussian_rows_plain(rows, weights, radius, channels)
    height, width = check_rows(rows, channels)
    if (weights.device != rows.device or weights.dtype != torch.float32
            or tuple(weights.shape) != (2 * radius + 1,)
            or not weights.is_contiguous()):
        raise ValueError(
            f"weights must be a contiguous ({2 * radius + 1},) float32 tensor "
            f"on {rows.device}")
    out = _launch("gip_gaussian_rows", rows, weights.data_ptr(), radius,
                  height, width, channels)
    LAUNCHES["gaussian_rows"] += 1
    return out


def box_rows(rows: torch.Tensor, radius: int, channels: int) -> torch.Tensor:
    """Separable box blur of (H, W*C) uint8 rows, any radius >= 1."""
    if rows.device.type == "cpu":
        return box_rows_plain(rows, radius, channels)
    height, width = check_rows(rows, channels)
    if radius < 1:
        raise ValueError(f"radius must be >= 1; got {radius}")
    out = _launch("gip_box_rows", rows, float(box_inv_taps_f32(radius)), radius,
                  height, width, channels)
    LAUNCHES["box_rows"] += 1
    return out
