"""The Sobel kernel of `sobel.cu` and its plain torch version.

`sobel_rows` replaces the TPU kernels `ops/pallas/sobel.py::
_sobel_kernel_interleaved` and, at level 2, `ops/pallas/sobel_mxu.py::
_sobel_mxu_kernel`.  It takes (H, W*C) uint8 rows with C in {1, 3, 4} and
computes the level-2 edge map (grey quantized to uint8 before the
gradients).  On a CPU tensor it returns the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.config import VALID_CHANNELS
from .. import interleaved
from . import LAUNCHES, build
from .blur import check_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gip_sobel_rows": [_P, _P, _I, _I, _I, _P]}


def sobel_rows_plain(rows: torch.Tensor, width: int,
                     channels: int) -> torch.Tensor:
    """The kernel's function in plain torch ops (level-2 numerics)."""
    return interleaved.sobel_rows(rows, 2, width, channels)


def sobel_rows(rows: torch.Tensor, width: int, channels: int) -> torch.Tensor:
    """Level-2 Sobel edge map of (H, W*C) uint8 rows, written to every
    channel, with a zeroed 1-pixel border."""
    if rows.device.type == "cpu":
        return sobel_rows_plain(rows, width, channels)
    height, got_width = check_rows(rows, channels)
    if channels not in VALID_CHANNELS or got_width != width:
        raise ValueError(
            f"expected {width} pixels of C in {VALID_CHANNELS}; got "
            f"{got_width} of C={channels}")
    lib = build.load("sobel", rows.device, _SIGNATURES)
    out = torch.empty_like(rows)
    with torch.cuda.device(rows.device):
        code = lib.gip_sobel_rows(rows.data_ptr(), out.data_ptr(), height,
                                  width, channels,
                                  build.stream_handle(rows.device))
    build.check(lib, code, "gip_sobel_rows")
    LAUNCHES["sobel_rows"] += 1
    return out
