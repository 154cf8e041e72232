"""Modeled traffic and tensor-core work of the port's kernels.

The deep profile (profiling/profiler.py) turns measured durations into
rates against these models.  Every number here is arithmetic on shapes,
not a hardware counter: rows that use one are tagged
``bytes_source: "modeled"``.

* `io_bytes`: the floor any implementation moves, the image read once and
  written once a launch.
* `kernel_operations` and `least_ms`: the operations each hand kernel's
  function needs, the rate they run at, and the least time a launch could
  take, the larger of its bytes over the memory rate and its operations over
  their rate (the bound beside every kernel time in `chip_smoke.py` and
  `tools/sol_report.py`).
* `served_tensor_core_flops`: the bf16 products the tensor cores issue for
  a request.  Only the band runs on them (`ops/cuda/api.py::uses_band`,
  `gaussian_band_rows`, `blur.cu::band_mma_rows`); the model
  follows that kernel's tiles.  Box and Sobel, which the TPU ran on its
  matrix unit, run on the CUDA cores here, so the model gives None for
  them (and for every other route).
"""

from __future__ import annotations

from typing import Optional

from ..ops.cuda.api import uses_band

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
    when it issues none: every route but the band (`uses_band`)."""
    if radius is None or not uses_band(filter_name, level, radius):
        return None
    return band_mma_flops(height, width, channels, radius, batch)


#: Operations for each output element of one pass of a separable kernel at
#: radius r, 2r + 1 taps: weighted 2(2r+1) (a multiply and an add a tap);
#: folded 3r+2 (r pair sums, r+1 multiplies, r+1 adds); the band 4(2r+1)+1
#: (two products and two sums a tap, then hi + lo); box 4 at any radius (a
#: running window sum adds the incoming tap and subtracts the outgoing one,
#: then the scale and the rounding add), since the window sum is exact in
#: any order and needs no more.
PASS_OPERATIONS = {
    "gaussian_rows": lambda r: 2 * (2 * r + 1),
    "gaussian_planar": lambda r: 2 * (2 * r + 1),
    "gaussian_folded_rows": lambda r: 3 * r + 2,
    "gaussian_folded_planar": lambda r: 3 * r + 2,
    "gaussian_band_rows": lambda r: 4 * (2 * r + 1) + 1,
    "box_rows": lambda r: 4,
    "box_planar": lambda r: 4,
}
#: Sobel's operations a pixel: 5 for the grey value, 11 each for gx and gy,
#: 8 for the magnitude and its rounding.
SOBEL_PIXEL_OPERATIONS = 5 + 11 + 11 + 8
SOBEL_KERNELS = ("sobel_rows", "sobel_f32_rows", "sobel_planar",
                 "sobel_f32_planar")
#: The one kernel whose products run on the tensor cores: u8 pixels times
#: bf16 weights, exact in bf16, summed in f32, the band matmul the TPU ran
#: on its matrix unit.  Every other kernel runs at the float32 rate of one
#: instruction an operation (they build with -fmad=false).
TENSOR_CORE_KERNELS = ("gaussian_band_rows",)


def kernel_operations(name: str, shape: tuple[int, ...], radius: int) -> int:
    """Operations hand kernel `name` needs for one launch on (..., H, W, C)
    uint8: both passes of a blur over every element, or Sobel over every
    pixel."""
    elems = 1
    for d in shape:
        elems *= d
    if name in SOBEL_KERNELS:
        return SOBEL_PIXEL_OPERATIONS * (elems // shape[-1])
    return 2 * PASS_OPERATIONS[name](radius) * elems


def operations_rate(name: str, peaks) -> float:
    """The rate, operations a second, `name`'s operations run at on a card
    of `peaks` (profiling/profiler.py::DevicePeaks)."""
    return (peaks.bf16_tensor_ops_per_s if name in TENSOR_CORE_KERNELS
            else peaks.f32_ops_per_s)


def least_ms(name: str, shape: tuple[int, ...], radius: int,
             peaks) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations") of one launch of hand
    kernel `name` on (..., H, W, C) uint8 at `radius`: each input byte read
    once and each output byte written once over the memory rate, against
    `kernel_operations` over `operations_rate`, whichever is longer."""
    bytes_ms = io_bytes(*shape) / peaks.hbm_bytes_per_s * 1e3
    ops_ms = (kernel_operations(name, shape, radius)
              / operations_rate(name, peaks) * 1e3)
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
