"""Filter dispatch: validation, routing to a tier, timing, and the metrics
triplet.

The replacement for the reference's host orchestrators
(`gaussianBlur`/`boxBlur`/`sobelEdgeDetection`, image_filters.cu:679-1119,
1603-1739).  A `FilterRuntime` is bound to one explicit `torch.device`.
Images cross to the device as (H, W*C) uint8 rows, the HWC bytes viewed 2-D.

* Level 1 runs the plain torch ops of `ops/interleaved.py` on that device.
* Level 2 runs the hand-written kernels of `ops/cuda/`.  On a CUDA device
  they launch the kernel for every shape; a kernel that fails to build or
  launch raises.  On the CPU their wrappers serve the plain torch version.
* Level 4 is not ported yet and raises.

Only the filter's device work is timed (runtime/timing.py); the copies to
and from the device are not.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import config
from ..core.metrics import PerformanceMetrics, compute_metrics
from ..core.params import (
    FILTERS,
    ValidationError,
    normalize_level,
    validate_box_params,
    validate_gaussian_params,
    validate_image_shape,
)
from ..ops import interleaved
from ..ops.cuda import blur, sobel
from ..ops.weights import gaussian_kernel_f32, weights_to_torch
from .device import resolve
from .timing import timed

Rows = torch.Tensor


def _level(filter_name: str, level: int) -> int:
    lvl = normalize_level(filter_name, level)
    if lvl == 4:
        raise ValidationError("level 4 is not ported yet")
    return lvl


class FilterRuntime:
    """The public run API on one explicit device."""

    def __init__(self, device: torch.device | str):
        self.device = resolve(device)
        # (filter, level, shape, radius) keys whose untimed first run is
        # done: that run builds the kernels and warms the allocator.
        self._warm: set[tuple] = set()

    def _serve(self, filter_name: str, lvl: int, radius: int | None,
               image: np.ndarray, fn: Callable[[Rows], Rows],
               ) -> tuple[np.ndarray, PerformanceMetrics]:
        height, width, channels = image.shape
        host = np.require(image, np.uint8, ["C", "W"]).reshape(height, -1)
        rows = torch.from_numpy(host).to(self.device)
        key = (filter_name, lvl, height, width, channels, radius)
        if key not in self._warm:
            fn(rows)
            self._warm.add(key)
        out, ms = timed(lambda: fn(rows), self.device, config.TIMING_REPS)
        out_np = out.cpu().numpy().reshape(height, width, channels)
        return out_np, compute_metrics(
            ms, width, height, channels, FILTERS[filter_name].bytes_factor)

    # -- public API --------------------------------------------------------

    def gaussian_blur(
        self,
        image: np.ndarray,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
        level: int = config.DEFAULT_LEVEL,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        _, _, channels = validate_image_shape(image.shape)
        lvl = _level("gaussian", level)
        validate_gaussian_params(sigma, radius)
        weights = weights_to_torch(gaussian_kernel_f32(radius, float(sigma)),
                                   self.device)
        impl = interleaved.gaussian_rows if lvl == 1 else blur.gaussian_rows
        return self._serve("gaussian", lvl, radius, image,
                           lambda rows: impl(rows, weights, radius, channels))

    def box_blur(
        self,
        image: np.ndarray,
        radius: int = config.DEFAULT_RADIUS,
        level: int = config.DEFAULT_LEVEL,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        _, _, channels = validate_image_shape(image.shape)
        lvl = _level("box", level)
        validate_box_params(radius)
        impl = interleaved.box_rows if lvl == 1 else blur.box_rows
        return self._serve("box", lvl, radius, image,
                           lambda rows: impl(rows, radius, channels))

    def sobel_edge_detection(
        self, image: np.ndarray, level: int = config.DEFAULT_LEVEL
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        _, width, channels = validate_image_shape(image.shape)
        lvl = _level("sobel", level)

        def fn(rows: Rows) -> Rows:
            if lvl == 1:
                return interleaved.sobel_rows(rows, 1, width, channels)
            return sobel.sobel_rows(rows, width, channels)

        return self._serve("sobel", lvl, None, image, fn)

    def run(
        self,
        filter_name: str,
        image: np.ndarray,
        level: int = 1,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        """Generic entry used by the server layer."""
        if filter_name == "gaussian":
            return self.gaussian_blur(image, sigma=sigma, radius=radius, level=level)
        if filter_name == "box":
            return self.box_blur(image, radius=radius, level=level)
        if filter_name == "sobel":
            return self.sobel_edge_detection(image, level=level)
        raise ValidationError(
            f"Invalid filter: {filter_name}. Must be 'gaussian', 'box', or 'sobel'"
        )

    def run_all_levels(
        self,
        filter_name: str,
        image: np.ndarray,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
        levels: tuple[int, ...] = config.VALID_LEVELS,
    ) -> dict[int, tuple[np.ndarray, PerformanceMetrics]]:
        """Every requested level of one filter, one after another (the
        /api/process-all work).  Raises if any level fails."""
        return {lv: self.run(filter_name, image, level=lv, sigma=sigma,
                             radius=radius)
                for lv in levels}
