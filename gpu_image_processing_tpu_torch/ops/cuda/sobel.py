"""The Sobel kernels of `sobel.cu` and their plain torch versions.

`sobel_rows` (grey quantized to uint8, level 2) and `sobel_f32_rows` (grey
kept in f32, the level-1 numerics that level 4 serves) replace the TPU
kernels `ops/pallas/sobel.py::_sobel_kernel_interleaved` and
`ops/pallas/sobel_mxu.py::_sobel_mxu_kernel`.  They take (H, W*C) uint8
rows, or a (B, H, W*C) batch, with C in {1, 3, 4}: one template,
`sobel_tile_rows`, whose blocks stage a tile with 16-byte loads, compute
each pixel's grey value once into shared memory, run 3x3 register windows
down columns and store the replicated magnitude with 16-byte stores.  The
planar Sobel (`sobel_planar.py`) launches the same template on planes.  On a
CPU tensor they return the plain version; on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ...core import spans
from ...core.config import VALID_CHANNELS
from .. import interleaved
from . import build, plan
from .blur import check_rows

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gip_sobel_rows": [_P, _P, _I, _I, _I, _I, _P],
    "gip_sobel_f32_rows": [_P, _P, _I, _I, _I, _I, _P],
    # The planar Sobel (sobel_planar.py): the same template on planes.
    "gip_sobel_planar": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gip_sobel_f32_planar": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
}

#: Output rows of one launch: a tile is 8 rows, and the grid's y dimension
#: holds at most 65535 tiles.
MAX_HEIGHT = 65535 * 8


def sobel_rows_plain(rows: torch.Tensor, width: int,
                     channels: int) -> torch.Tensor:
    """`sobel_rows` in plain torch ops (level-2 numerics)."""
    return interleaved.sobel_rows(rows, 2, width, channels)


def sobel_f32_rows_plain(rows: torch.Tensor, width: int,
                         channels: int) -> torch.Tensor:
    """`sobel_f32_rows` in plain torch ops (level-1 numerics)."""
    return interleaved.sobel_rows(rows, 1, width, channels)


def library(device: torch.device) -> ctypes.CDLL:
    """sobel.cu's library, built first if needed."""
    return build.load("sobel", device, _SIGNATURES)


#: Each launch function's `LAUNCHES` name.
_COUNTED = {"gip_sobel_rows": "sobel_rows",
            "gip_sobel_f32_rows": "sobel_f32_rows",
            "gip_sobel_planar": "sobel_planar",
            "gip_sobel_f32_planar": "sobel_f32_planar"}


def _make_plan(fn_name: str, rows: torch.Tensor) -> plan.Plan:
    return plan.Plan(library(rows.device), fn_name, _COUNTED[fn_name], None,
                     rows.get_device())


def plan_for(fn_name: str, rows: torch.Tensor, channels: int) -> plan.Plan:
    """The plan of a launch of `fn_name` at `channels` on `rows`' card
    (`plan.py`), counted by its wrapper's name."""
    return plan.get((fn_name, 0, channels, rows.get_device()), _make_plan,
                    fn_name, rows)


def _launch(fn_name: str, rows: torch.Tensor, width: int,
            channels: int) -> torch.Tensor:
    with spans.span("ops.launch"):
        batch, height, got_width = check_rows(rows, channels)
        if channels not in VALID_CHANNELS or got_width != width:
            raise ValueError(
                f"expected {width} pixels of C in {VALID_CHANNELS}; got "
                f"{got_width} of C={channels}")
        p = plan_for(fn_name, rows, channels)
        out = torch.empty_like(rows)
        p.launch(rows.data_ptr(), out.data_ptr(), batch, height, width,
                 channels)
        return out


def sobel_rows(rows: torch.Tensor, width: int, channels: int) -> torch.Tensor:
    """Level-2 Sobel edge map (quantized grey), written to every channel,
    with a zeroed 1-pixel border on each image."""
    if rows.is_cpu:
        return sobel_rows_plain(rows, width, channels)
    return _launch("gip_sobel_rows", rows, width, channels)


def sobel_f32_rows(rows: torch.Tensor, width: int,
                   channels: int) -> torch.Tensor:
    """Sobel edge map with the grey value kept in f32 (level 4)."""
    if rows.is_cpu:
        return sobel_f32_rows_plain(rows, width, channels)
    return _launch("gip_sobel_f32_rows", rows, width, channels)
