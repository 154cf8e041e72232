"""The least time a filter call needs on the card: the yardstick of
`kernels_roofline`.

A frozen copy of `gpu_image_processing_tpu_torch/profiling/traffic.py`'s
arithmetic (`io_bytes`, `PASS_OPERATIONS`, `SOBEL_PIXEL_OPERATIONS`,
`least_ms`), keyed by the filter function a call computes (filter, level,
shape, radius) and not by the kernel that happens to compute it, so that a
change that fuses, removes or replaces a kernel is read against the same
work.  Each input byte is read once and each output byte written once;
the operations are those the function needs at that radius, at the
float32 rate outside the tensor cores, whatever unit a kernel runs them
on.  The least time is the larger of bytes over the memory rate and
operations over the operation rate.
"""

from __future__ import annotations

from math import prod

#: Published peaks of one NVIDIA H100 SXM (data sheet; dense, at the full
#: 700 W power limit): HBM3 bytes a second, float32 operations a second
#: outside the tensor cores.
H100_SXM = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}


def pass_operations(filter_name: str, level: int, radius: int) -> int:
    """Operations for each output element of one pass of a blur: the
    weighted taps, a multiply and an add a tap, for the gaussian at every
    level (levels 2 and 4 compute the level-1 function, or within one of
    it); 4 for the box at any radius (a running window sum adds the
    incoming tap and subtracts the outgoing one, then the scale and the
    rounding add)."""
    if filter_name == "gaussian":
        return 2 * (2 * radius + 1)
    if filter_name == "box":
        return 4
    raise ValueError(f"{filter_name} is not a separable blur")


#: Sobel's operations a pixel: 5 for the grey value, 11 each for gx and gy,
#: 8 for the magnitude and its rounding.
SOBEL_PIXEL_OPERATIONS = 5 + 11 + 11 + 8


def call_work(filter_name: str, level: int, shape: tuple[int, ...],
              radius: int) -> tuple[int, int]:
    """(bytes, operations) one call of the filter needs on (..., H, W, C)
    uint8: the image read once and written once; both passes of a blur
    over every element, or Sobel over every pixel."""
    elems = prod(shape)
    if filter_name == "sobel":
        return 2 * elems, SOBEL_PIXEL_OPERATIONS * (elems // shape[-1])
    return 2 * elems, 2 * pass_operations(filter_name, level, radius) * elems


def least_seconds(filter_name: str, level: int, shape: tuple[int, ...],
                  radius: int, peaks: dict = H100_SXM) -> float:
    """The least time one call could take on a card of `peaks`."""
    nbytes, ops = call_work(filter_name, level, shape, radius)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_ops_per_s"])
