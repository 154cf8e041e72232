"""The planar blur (K5) and its plain versions.

`gaussian_planar` (level 2), `gaussian_folded_planar` (level 4, r < 3) and
`box_planar` replace the TPU kernel `ops/pallas/blur.py::_blur_kernel` as
`_separable_blur_planar` launches it on planes.  Each takes (N, H, W) uint8
planes, the C planes of one image or the B*C planes of a batch, and blurs
every plane on its own in one launch, both passes in it.  With
`rows_prepadded=True` the input is (N, H + 2r, W): r given halo rows above
and below each plane, which the vertical pass reads unclamped.

A plane is an image of one channel, so these launch the rows kernels of
`blur.cu` at one channel, `gauss_window_rows` (`gauss_pair_rows` where
`blur.gaussian_rows` takes it) and `box_window_rows` (box routed on the
radius as `blur.box_rows` routes it), whose staging reads the halo rows
when they are given.  They take
2r + 1 <= `MAX_KERNEL_TAPS` taps (r <= 31), as the TPU kernel's planar path
did; a larger radius raises ValueError, on every device.  On a CPU tensor a
wrapper returns the plain version; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from ...core import spans
from ...core.config import MAX_KERNEL_TAPS
from .. import interleaved
from . import blur
from .blur import MAX_BATCH, check_table

#: Output rows of one launch: the window kernels' row bands are at least 32
#: rows, and the grid's y dimension holds at most 65535 of them.
MAX_HEIGHT = 65535 * 32


def gaussian_planar_plain(planes: torch.Tensor, weights: torch.Tensor,
                          radius: int, rows_prepadded: bool = False
                          ) -> torch.Tensor:
    """`gaussian_planar` in plain torch ops."""
    return interleaved.gaussian_rows(planes, weights, radius, 1, rows_prepadded)


def gaussian_folded_planar_plain(planes: torch.Tensor, weights: torch.Tensor,
                                 radius: int, rows_prepadded: bool = False
                                 ) -> torch.Tensor:
    """`gaussian_folded_planar` in plain torch ops."""
    return interleaved.gaussian_rows_folded(planes, weights, radius, 1,
                                            rows_prepadded)


def box_planar_plain(planes: torch.Tensor, radius: int,
                     rows_prepadded: bool = False) -> torch.Tensor:
    """`box_planar` in plain torch ops."""
    return interleaved.box_rows(planes, radius, 1, rows_prepadded)


def check_planes(planes: torch.Tensor, radius: int,
                 rows_prepadded: bool) -> tuple[int, int, int]:
    """(planes, output height, width) of contiguous (N, H[+2r], W) uint8
    planes at a radius the planar blur takes; raises otherwise."""
    if (planes.dtype != torch.uint8 or planes.dim() != 3
            or not planes.is_contiguous()):
        raise ValueError(
            f"expected contiguous (N, H, W) uint8 planes; got {planes.dtype} "
            f"{tuple(planes.shape)}")
    if radius < 1:
        raise ValueError(f"radius must be >= 1; got {radius}")
    if 2 * radius + 1 > MAX_KERNEL_TAPS:
        raise ValueError(
            f"the planar blur takes at most MAX_KERNEL_TAPS = "
            f"{MAX_KERNEL_TAPS} taps (r <= {(MAX_KERNEL_TAPS - 1) // 2}); got "
            f"r = {radius}")
    n, rows, width = planes.shape
    height = rows - 2 * radius if rows_prepadded else rows
    if height < 1 or width < 1:
        raise ValueError(
            f"planes of {rows} rows x {width} hold no output at r = {radius}"
            f"{' with halo rows' if rows_prepadded else ''}")
    if not 1 <= n <= MAX_BATCH or height > MAX_HEIGHT:
        raise ValueError(f"{n} planes of {height} rows; one launch takes 1 to "
                         f"{MAX_BATCH} planes of at most {MAX_HEIGHT} rows")
    return n, height, width


def _launch(fn_name: str, planes: torch.Tensor, dims: tuple[int, int, int],
            radius: int, rows_prepadded: bool, table_or_scale) -> torch.Tensor:
    """Launch one of blur.cu's planar functions, and count the launch (a
    launch at one channel); `table_or_scale` is the gaussian's table (a
    tensor, copied into the launch) or the box's f32 scale."""
    with spans.span("ops.launch"):
        n, height, width = dims
        p = blur.plan_for(fn_name, planes, radius, 1)
        route_key = None
        if isinstance(table_or_scale, torch.Tensor):
            table_or_scale, route_key = p.host_taps(table_or_scale)
        out = torch.empty((n, height, width), dtype=torch.uint8,
                          device=planes.device)
        p.launch(planes.data_ptr(), out.data_ptr(), table_or_scale, radius, n,
                 height, width, int(rows_prepadded), route_key=route_key)
        return out


def gaussian_planar(planes: torch.Tensor, weights: torch.Tensor, radius: int,
                    rows_prepadded: bool = False) -> torch.Tensor:
    """Separable gaussian blur of each plane, level-2 numerics.

    `weights` is the (2r+1,) float32 table, on the host or on `planes`'
    device; the kernel takes its values by value, so a table on the card is
    read back first, which waits for the card.
    """
    dims = check_planes(planes, radius, rows_prepadded)
    check_table(weights, planes, radius, "weights", on_host=True)
    if planes.is_cpu:
        return gaussian_planar_plain(planes, weights, radius, rows_prepadded)
    return _launch("gip_gaussian_planar", planes, dims, radius,
                   rows_prepadded, weights)


def gaussian_folded_planar(planes: torch.Tensor, weights: torch.Tensor,
                           radius: int, rows_prepadded: bool = False
                           ) -> torch.Tensor:
    """Separable gaussian blur of each plane with symmetric tap pairs
    (level 4, r < 3); `weights` as in `gaussian_planar`."""
    dims = check_planes(planes, radius, rows_prepadded)
    check_table(weights, planes, radius, "weights", on_host=True)
    if planes.is_cpu:
        return gaussian_folded_planar_plain(planes, weights, radius,
                                            rows_prepadded)
    return _launch("gip_gaussian_folded_planar", planes, dims, radius,
                   rows_prepadded, weights)


def box_planar(planes: torch.Tensor, radius: int,
               rows_prepadded: bool = False) -> torch.Tensor:
    """Separable box blur of each plane (int32 window sums, exact at levels
    2 and 4)."""
    dims = check_planes(planes, radius, rows_prepadded)
    if planes.is_cpu:
        return box_planar_plain(planes, radius, rows_prepadded)
    return _launch("gip_box_planar", planes, dims, radius, rows_prepadded,
                   blur.box_scale(radius))
