"""The planar Sobel (K6, K7) and its plain version.

`sobel_planar` (grey quantized to uint8, level 2) and `sobel_f32_planar`
(grey kept in f32, the level-1 numerics that level 4 serves) replace the TPU
kernels `ops/pallas/sobel.py::_sobel_kernel` (the (C, H, W) planes of one
image) and `_sobel_kernel_batch` (a (B, C, H, W) batch), C in {1, 3, 4}.
With `rows_prepadded=True` each image has one given halo row above and
below (H + 2 rows in, H out); `zero_rows=False` leaves the first and last
rows as computed, for a caller that zeroes the whole image's border rows
itself.  They launch `sobel.cu`'s `sobel_tile_rows` template in its planar
layout.  On a CPU tensor they return the plain version; on a CUDA tensor
they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from ...core import spans
from ...core.config import VALID_CHANNELS
from .. import interleaved
from ..rounding import quantize_u8_f32
from . import sobel
from .blur import MAX_BATCH
from .sobel import MAX_HEIGHT


def sobel_planar_plain(planes: torch.Tensor, level: int,
                       rows_prepadded: bool = False,
                       zero_rows: bool = True) -> torch.Tensor:
    """The kernel's function in plain torch ops on (..., C, H[+2], W) uint8
    planes: level 2 quantizes the grey value, level 1 keeps it in f32."""
    gray = interleaved.grayscale(planes.to(torch.float32), -3)
    if level == 2:
        gray = quantize_u8_f32(gray)
    edge = interleaved.sobel_magnitude(gray, rows_prepadded, zero_rows)
    return edge.unsqueeze(-3).expand(
        *planes.shape[:-2], *edge.shape[-2:]).contiguous()


def check_planes(planes: torch.Tensor,
                 rows_prepadded: bool) -> tuple[int, int, int, int]:
    """(batch, channels, output height, width) of contiguous (C, H[+2], W)
    or (B, C, H[+2], W) uint8 planes; raises otherwise."""
    if (planes.dtype != torch.uint8 or planes.dim() not in (3, 4)
            or not planes.is_contiguous()):
        raise ValueError(
            f"expected contiguous (C, H, W) or (B, C, H, W) uint8 planes; got "
            f"{planes.dtype} {tuple(planes.shape)}")
    batch = planes.shape[0] if planes.dim() == 4 else 1
    channels, rows, width = planes.shape[-3:]
    height = rows - 2 if rows_prepadded else rows
    if channels not in VALID_CHANNELS:
        raise ValueError(f"channels must be one of {VALID_CHANNELS}; got "
                         f"{channels}")
    if height < 1 or width < 1:
        raise ValueError(f"planes of {rows} rows x {width} hold no output"
                         f"{' with halo rows' if rows_prepadded else ''}")
    if not 1 <= batch <= MAX_BATCH or height > MAX_HEIGHT:
        raise ValueError(f"{batch} images of {height} rows; one launch takes "
                         f"1 to {MAX_BATCH} images of at most {MAX_HEIGHT} rows")
    return batch, channels, height, width


def _launch(fn_name: str, planes: torch.Tensor, rows_prepadded: bool,
            zero_rows: bool) -> torch.Tensor:
    with spans.span("ops.launch"):
        batch, channels, height, width = check_planes(planes, rows_prepadded)
        p = sobel.plan_for(fn_name, planes, channels)
        out = torch.empty((*planes.shape[:-2], height, width),
                          dtype=torch.uint8, device=planes.device)
        p.launch(planes.data_ptr(), out.data_ptr(), batch, channels, height,
                 width, int(rows_prepadded), int(zero_rows))
        return out


def sobel_planar(planes: torch.Tensor, rows_prepadded: bool = False,
                 zero_rows: bool = True) -> torch.Tensor:
    """Level-2 Sobel edge map (quantized grey) of (C, H, W) or (B, C, H, W)
    planes, written to every plane, with a zeroed 1-pixel border."""
    if planes.is_cpu:
        check_planes(planes, rows_prepadded)
        return sobel_planar_plain(planes, 2, rows_prepadded, zero_rows)
    return _launch("gip_sobel_planar", planes, rows_prepadded, zero_rows)


def sobel_f32_planar(planes: torch.Tensor, rows_prepadded: bool = False,
                     zero_rows: bool = True) -> torch.Tensor:
    """Sobel edge map of planes with the grey value kept in f32 (level 4)."""
    if planes.is_cpu:
        check_planes(planes, rows_prepadded)
        return sobel_planar_plain(planes, 1, rows_prepadded, zero_rows)
    return _launch("gip_sobel_f32_planar", planes, rows_prepadded, zero_rows)
