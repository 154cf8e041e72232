"""Modeled traffic and tensor-core work of the port's kernels.

The deep profile (profiling/profiler.py) turns measured durations into
rates against these models.  Every number here is arithmetic on shapes,
not a hardware counter: rows that use one are tagged
``bytes_source: "modeled"``.

* `io_bytes`: the floor any implementation moves, the image read once and
  written once a launch, as `chip_smoke.py::bound` counts it.
* `served_tensor_core_flops`: the bf16 products the tensor cores issue for
  a request.  Only the level-4 gaussian from `GAUSS_MXU_MIN_RADIUS` up runs
  on them (`gaussian_band_rows`, `blur.cu::band_mma_rows`); the model
  follows that kernel's tiles.  Box and Sobel, which the TPU ran on its
  matrix unit, run on the CUDA cores here, so the model gives None for
  them (and for every other route).
"""

from __future__ import annotations

from typing import Optional

from ..core.config import GAUSS_MXU_MIN_RADIUS

BYTES_SOURCE = "modeled"

# band_mma_rows's geometry (blur.cu): a block owns a 64-row x 128-lane
# output tile and issues 16 x 16 x 16 bf16 products (wmma), a hi and a lo
# product for each step of each band's depth.
_TILE_H, _TILE_W, _MMA = 64, 128, 16
_FLOPS_PER_MMA = 2 * _MMA * _MMA * _MMA


def io_bytes(*shape: int) -> int:
    """Bytes of a uint8 image (or batch) of `shape` read once and written
    once."""
    n = 1
    for d in shape:
        n *= d
    return 2 * n


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def band_mma_flops(height: int, width: int, channels: int, radius: int,
                   batch: int = 1) -> int:
    """Tensor-core FLOPs one launch of `band_mma_rows` issues on (batch, H,
    W*C) rows: per block, the horizontal band over the tile's rows and the
    2r halo rows (depth 16 + 2rC, in 16s), then the vertical band over the
    tile (depth 16 + 2r, in 16s), each as a hi and a lo product."""
    depth_h = (2 * radius * channels + 31) // 16 * 16
    depth_v = (2 * radius + 31) // 16 * 16
    lanes = width * channels
    mmas = 0
    for y0 in range(0, height, _TILE_H):
        row_tiles = _ceil(min(_TILE_H, height - y0), _MMA)
        h_row_tiles = row_tiles - 1 + depth_v // _MMA
        for l0 in range(0, lanes, _TILE_W):
            col_tiles = _ceil(min(_TILE_W, lanes - l0), _MMA)
            mmas += 2 * (h_row_tiles * col_tiles * depth_h // _MMA
                         + row_tiles * col_tiles * depth_v // _MMA)
    return batch * mmas * _FLOPS_PER_MMA


def served_tensor_core_flops(filter_name: str, level: int, height: int,
                             width: int, channels: int,
                             radius: Optional[int] = None,
                             batch: int = 1) -> Optional[int]:
    """Modeled tensor-core FLOPs of the kernel serving this request, or None
    when it issues none: every route but the level-4 gaussian from
    `GAUSS_MXU_MIN_RADIUS` (runtime/dispatch.py::_rows_fn)."""
    if (filter_name != "gaussian" or level != 4 or radius is None
            or radius < GAUSS_MXU_MIN_RADIUS):
        return None
    return band_mma_flops(height, width, channels, radius, batch)
