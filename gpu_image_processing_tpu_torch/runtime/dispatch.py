"""Filter dispatch: validation, routing to a tier, timing, and the metrics
triplet.

The replacement for the reference's host orchestrators
(`gaussianBlur`/`boxBlur`/`sobelEdgeDetection`, image_filters.cu:679-1119,
1603-1739).  A `FilterRuntime` is bound to one explicit `torch.device`.
Images cross to the device as (H, W*C) uint8 rows, the HWC bytes viewed 2-D,
and a batch as (B, H, W*C).

* Level 1 runs the plain torch ops of `ops/interleaved.py` on that device.
* Levels 2 and 4 run the hand-written kernels of `ops/cuda/`.  On a CUDA
  device they launch the kernel for every shape; a kernel that fails to
  build or launch raises.  On the CPU their wrappers serve the plain torch
  version.
* Level 4 (ADVANCED, within 1 of level 2) routes as the JAX package does
  (gpu_image_processing_tpu/runtime/dispatch.py:217-371): gaussian with
  folded taps below `GAUSS_MXU_MIN_RADIUS` and with the bf16 hi + lo band
  from it up; box on the exact level-2 kernel (every TPU route for it is
  exact too); Sobel with the grey value kept in f32.

Only the filter's device work is timed (runtime/timing.py): the card's
queue is filled before the start event, so the host's enqueue falls outside
it, at level 1 as at the kernel levels; the copies to and from the device
are not timed.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..core import config
from ..core.config import GAUSS_MXU_MIN_RADIUS
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
from ..ops.weights import bf16_split, gaussian_kernel_f32, weights_to_torch
from .device import resolve
from .timing import timed

Rows = torch.Tensor
RowsFn = Callable[[Rows], Rows]


def _check_filter(filter_name: str) -> None:
    if filter_name not in FILTERS:
        raise ValidationError(
            f"Invalid filter: {filter_name}. Must be 'gaussian', 'box', or 'sobel'"
        )


class FilterRuntime:
    """The public run API on one explicit device."""

    def __init__(self, device: torch.device | str):
        self.device = resolve(device)
        # (filter, level, shape, radius) keys whose untimed first run is
        # done (that run builds the kernels and warms the allocator), each
        # with the host's time to enqueue the call in ms, which sizes the
        # card's spin before the timed runs (runtime/timing.py).
        self._warm: dict[tuple, float] = {}

    def _rows_fn(self, filter_name: str, lvl: int, sigma: float, radius: int,
                 width: int, channels: int) -> RowsFn:
        """The function of (..., H, W*C) rows that serves this request."""
        if filter_name == "gaussian":
            table = gaussian_kernel_f32(radius, float(sigma))
            if lvl == 4 and radius >= GAUSS_MXU_MIN_RADIUS:
                hi, lo = (weights_to_torch(t, self.device)
                          for t in bf16_split(table))
                return lambda rows: blur.gaussian_band_rows(
                    rows, hi, lo, radius, channels)
            # The level-2 and level-4 kernels take their taps by value, from
            # the host; level 1 computes with them on the device.
            weights = weights_to_torch(
                table, self.device if lvl == 1 else torch.device("cpu"))
            impl = {1: interleaved.gaussian_rows, 2: blur.gaussian_rows,
                    4: blur.gaussian_folded_rows}[lvl]
            return lambda rows: impl(rows, weights, radius, channels)
        if filter_name == "box":
            impl = interleaved.box_rows if lvl == 1 else blur.box_rows
            return lambda rows: impl(rows, radius, channels)
        if lvl == 1:
            return lambda rows: interleaved.sobel_rows(rows, 1, width, channels)
        impl = sobel.sobel_rows if lvl == 2 else sobel.sobel_f32_rows
        return lambda rows: impl(rows, width, channels)

    def _prepare(self, filter_name: str, level: int, sigma: float, radius: int,
                 width: int, channels: int) -> tuple[int, RowsFn]:
        """Validate the filter's parameters; (level, rows function)."""
        _check_filter(filter_name)
        lvl = normalize_level(filter_name, level)
        if filter_name == "gaussian":
            validate_gaussian_params(sigma, radius)
        elif filter_name == "box":
            validate_box_params(radius)
        return lvl, self._rows_fn(filter_name, lvl, sigma, radius, width,
                                  channels)

    def _timed_run(self, key: tuple, host_rows: np.ndarray,
                   fn: RowsFn) -> tuple[np.ndarray, float]:
        rows = torch.from_numpy(host_rows).to(self.device)
        if key not in self._warm:
            t0 = time.perf_counter()
            fn(rows)
            self._warm[key] = (time.perf_counter() - t0) * 1000.0
        out, ms, self._warm[key] = timed(lambda: fn(rows), self.device,
                                         config.TIMING_REPS, self._warm[key])
        return out.cpu().numpy(), ms

    def _run_one(self, filter_name: str, image: np.ndarray, level: int,
                 sigma: float = config.DEFAULT_SIGMA,
                 radius: int = config.DEFAULT_RADIUS,
                 ) -> tuple[np.ndarray, PerformanceMetrics]:
        height, width, channels = validate_image_shape(image.shape)
        lvl, fn = self._prepare(filter_name, level, sigma, radius, width,
                                channels)
        host = np.require(image, np.uint8, ["C", "W"]).reshape(height, -1)
        key = (filter_name, lvl, 1, height, width, channels, radius)
        out, ms = self._timed_run(key, host, fn)
        return out.reshape(height, width, channels), compute_metrics(
            ms, width, height, channels, FILTERS[filter_name].bytes_factor)

    # -- public API --------------------------------------------------------

    def gaussian_blur(
        self,
        image: np.ndarray,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
        level: int = config.DEFAULT_LEVEL,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        return self._run_one("gaussian", image, level, sigma, radius)

    def box_blur(
        self,
        image: np.ndarray,
        radius: int = config.DEFAULT_RADIUS,
        level: int = config.DEFAULT_LEVEL,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        return self._run_one("box", image, level, radius=radius)

    def sobel_edge_detection(
        self, image: np.ndarray, level: int = config.DEFAULT_LEVEL
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        return self._run_one("sobel", image, level)

    def run(
        self,
        filter_name: str,
        image: np.ndarray,
        level: int = 1,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        """Generic entry used by the server layer."""
        _check_filter(filter_name)
        return self._run_one(filter_name, image, level, sigma, radius)

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

    def run_batch(
        self,
        filter_name: str,
        images: np.ndarray,
        level: int = 1,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        """Filter a (B, H, W, C) uint8 stack with one launch per kernel,
        each image clamped at its own edges
        (gpu_image_processing_tpu/runtime/dispatch.py:1453-1563).

        The metrics are for the whole batch; fps counts images per second.
        """
        if images.ndim != 4:
            raise ValidationError("Batch input must be 4D (batch, H, W, C)")
        batch = int(images.shape[0])
        if batch < 1:
            raise ValidationError("Batch must contain at least one image")
        height, width, channels = validate_image_shape(images.shape[1:])
        lvl, fn = self._prepare(filter_name, level, sigma, radius, width,
                                channels)
        host = np.require(images, np.uint8, ["C", "W"]).reshape(batch, height, -1)
        key = (filter_name, lvl, batch, height, width, channels, radius)
        out, ms = self._timed_run(key, host, fn)
        metrics = compute_metrics(ms, width, height, channels * batch,
                                  FILTERS[filter_name].bytes_factor)
        metrics.fps = batch * 1000.0 / max(metrics.time_ms, 1e-6)
        return out.reshape(batch, height, width, channels), metrics
