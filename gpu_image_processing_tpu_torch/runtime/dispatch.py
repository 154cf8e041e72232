"""Filter dispatch: validation, routing to a tier, timing, and the metrics
triplet.

The replacement for the reference's host orchestrators
(`gaussianBlur`/`boxBlur`/`sobelEdgeDetection`, image_filters.cu:679-1119,
1603-1739).  A `FilterRuntime` is bound to one explicit `torch.device`.
Images cross to the device as (H, W*C) uint8 rows, the HWC bytes viewed 2-D,
and a batch as (B, H, W*C).

* The function that serves a (filter, level, radius) is the one
  `ops/cuda/api.py::rows_function` names, where the rule is stated: level 1
  in plain torch ops on the device, levels 2 and 4 the hand-written kernels
  of `ops/cuda/`, which on a CUDA device launch for every shape or raise,
  and on the CPU serve their plain torch versions.
* Two opt-in multi-device paths (`FilterRuntime.mesh_devices`): row-sharded
  single-image serving over `parallel/spatial.py`'s halo-row shards, and
  mesh-batch serving, one block of the batch a device.

Only the filter's device work is timed (runtime/timing.py): the card's
queue is filled before the start event, so the host's enqueue falls outside
it, at level 1 as at the kernel levels; the copies to and from the device
are not timed.

On one device a call is served by its key's executable
(runtime/executable.py): buffers kept for the key, with pinned host
staging, and on the card, from the key's second request on, one captured
CUDA graph of the rows function, replayed (its first request launches
eagerly on the staged buffer).  The two multi-device paths run eagerly.

A call is the span `runtime.call` (core/spans.py), which opens a request
unless one is open on its thread (a server request's); its timed runs are
`runtime.bracket`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, ContextManager, NamedTuple, Sequence

import numpy as np
import torch

from ..core import config, spans
from ..core.metrics import PerformanceMetrics, compute_metrics
from ..core.params import (
    FILTERS,
    ValidationError,
    normalize_level,
    validate_box_params,
    validate_gaussian_params,
    validate_image_shape,
)
from ..ops.cuda import api as cuda_api
from ..ops.weights import gaussian_kernel_f32
from ..parallel.mesh import make_mesh
from ..parallel.spatial import make_sharded_filter, spatial_h_target
from .device import resolve
from .executable import (
    ExecutableCache,
    FilterExecutable,
    batch_cache_key,
    executable_cache_key,
)
from .timing import exclusive, timed


def _check_filter(filter_name: str) -> None:
    if filter_name not in FILTERS:
        raise ValidationError(
            f"Invalid filter: {filter_name}. Must be 'gaussian', 'box', or 'sobel'"
        )


class _Call(NamedTuple):
    """One request's device work, prepared: inside `staged()` its operands
    are on the device(s), so `run` is the whole timed region."""

    key: tuple                           # the warm or executable key
    run: Callable[[], Any]               # the device work
    devices: tuple[torch.device, ...]    # where it runs
    finish: Callable[[Any], np.ndarray]  # to the host, cropped
    path: str                            # the profiler's "Serving Path"
    level: int                           # the level whose function serves
    executable: FilterExecutable | None = None  # None: an eager mesh path
    rows: np.ndarray | None = None       # the request's rows, to stage

    def staged(self) -> ContextManager:
        """Where `run` and `finish` may be called: the executable held for
        this request with its rows staged (built first if need be)."""
        if self.executable is None:
            return contextlib.nullcontext()
        return self.executable.staged(self.rows)


def _mesh_spatial_min_rows() -> int:
    try:
        return int(os.environ.get("GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD",
                                  "64"))
    except ValueError:
        return 64


def _taps(filter_name: str, sigma: float, radius: int) -> np.ndarray | None:
    """The gaussian's f32 tap table, which its executable bakes in; None for
    the other filters."""
    if filter_name != "gaussian":
        return None
    return gaussian_kernel_f32(radius, float(sigma))


def _zero_true_border(out: np.ndarray) -> np.ndarray:
    """Sobel's 1-px border zeroed at the true image border."""
    out[0] = 0
    out[-1] = 0
    out[:, 0] = 0
    out[:, -1] = 0
    return out


class FilterRuntime:
    """The public run API on one explicit device.

    `mesh_devices` are the devices of the two opt-in multi-device paths
    (gpu_image_processing_tpu/runtime/dispatch.py:374-479), each switched
    on by its environment variable, read at every call:

    * ``GIP_TPU_MESH_SPATIAL=1``: the single-image calls (not
      `run_all_levels`) split an image's rows over the devices, with halo
      rows (parallel/spatial.py), for images of at least
      ``GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD`` (default 64) rows a device;
    * ``GIP_TPU_MESH_BATCH=1``: `run_batch` splits the batch over them.

    A path is taken only with more than one entry.  None means every
    visible card for a CUDA `device` and the one device on the CPU; a list
    may name one device several times (4 shards on one card).
    """

    def __init__(self, device: torch.device | str,
                 mesh_devices: Sequence[torch.device | str] | None = None):
        self.device = resolve(device)
        if mesh_devices is None:
            mesh_devices = ([torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())]
                            if self.device.type == "cuda" else [self.device])
        self.mesh_devices = tuple(resolve(d) for d in mesh_devices)
        # The one-device calls' executables (runtime/executable.py).
        self.executables = ExecutableCache(config.EXECUTABLE_CACHE_SIZE)
        # The eager multi-device paths' keys whose untimed first run is done
        # (that run builds the kernels and warms the allocator), each with
        # the host's time to enqueue the call in ms, which sizes the card's
        # spin before the timed runs (runtime/timing.py).
        self._warm: dict[tuple, float] = {}

    def _mesh_spatial_n(self, height: int) -> int:
        """Devices for row-sharded serving of an image of `height` rows, or
        0 (dispatch.py:437-467 there)."""
        n = len(self.mesh_devices)
        if os.environ.get("GIP_TPU_MESH_SPATIAL", "0") != "1" or n <= 1:
            return 0
        return n if height >= n * _mesh_spatial_min_rows() else 0

    def _mesh_batch_n(self) -> int:
        """Devices for mesh-batch serving, or 0 (dispatch.py:374-393 there)."""
        n = len(self.mesh_devices)
        if os.environ.get("GIP_TPU_MESH_BATCH", "0") != "1" or n <= 1:
            return 0
        return n

    def _validate(self, filter_name: str, level: int, sigma: float,
                  radius: int) -> int:
        """Validate the filter's parameters; the normalized level."""
        _check_filter(filter_name)
        lvl = normalize_level(filter_name, level)
        if filter_name == "gaussian":
            validate_gaussian_params(sigma, radius)
        elif filter_name == "box":
            validate_box_params(radius)
        return lvl

    def _timed(self, call: _Call) -> tuple[Any, float]:
        """(the last run's output, time_ms) of a staged call; a call's
        first run is untimed (for an executable, its build made it).  The
        timed runs are the span `runtime.bracket`."""
        exe = call.executable
        if exe is not None:
            with spans.span("runtime.bracket"):
                out, ms, exe.enqueue_ms = timed(
                    call.run, call.devices, config.TIMING_REPS, exe.enqueue_ms)
            return out, ms
        if call.key not in self._warm:
            with exclusive(call.devices):
                t0 = time.perf_counter()
                call.run()
                self._warm[call.key] = (time.perf_counter() - t0) * 1000.0
        with spans.span("runtime.bracket"):
            out, ms, self._warm[call.key] = timed(
                call.run, call.devices, config.TIMING_REPS,
                self._warm[call.key])
        return out, ms

    def _single_call(self, filter_name: str, image: np.ndarray, level: int,
                     sigma: float, radius: int, mesh: bool = True) -> _Call:
        """The prepared call of one (H, W, C) image: row-sharded when `mesh`
        and the switch route it there, else on the runtime's device."""
        height, width, channels = validate_image_shape(image.shape)
        lvl = self._validate(filter_name, level, sigma, radius)
        host = np.require(image, np.uint8, ["C", "W"])
        n = self._mesh_spatial_n(height) if mesh else 0
        if n:
            return self._spatial_call(filter_name, lvl, host, sigma, radius, n)
        key = executable_cache_key(filter_name, lvl, height, width, channels,
                                   radius, _taps(filter_name, sigma, radius),
                                   self.device)
        return self._executable_call(
            key, filter_name, lvl, sigma, radius, host.reshape(height, -1),
            (height, width, channels), "single_image")

    def _executable_call(self, key: tuple, filter_name: str, lvl: int,
                         sigma: float, radius: int, rows: np.ndarray,
                         shape: tuple[int, ...], path: str) -> _Call:
        """The call of `rows` through the executable of `key` on the
        runtime's device."""
        width, channels = shape[-2:]
        exe = self.executables.get(key, lambda: FilterExecutable(
            key, lambda: cuda_api.rows_function(
                filter_name, lvl, radius, channels, width,
                _taps(filter_name, sigma, radius), self.device),
            rows.shape, self.device, self.executables.record))
        return _Call(key, exe.run, (self.device,),
                     lambda out: exe.fetch(out).reshape(shape), path, lvl,
                     exe, rows)

    def _spatial_call(self, filter_name: str, lvl: int, image: np.ndarray,
                      sigma: float, radius: int, n: int) -> _Call:
        """Row-sharded serving over an sp-only mesh of `n` devices
        (dispatch.py:1369-1451 there).  The host edge-pads H to the
        mesh-divisible height and places each shard's rows on its device
        before the timed call, which holds every shard's launches and the
        halo copies.  Gaussian and box run the level-2 function at every
        level (bit-equal to levels 1 and 2); Sobel keeps its grey rule
        (level 4 serves level-1 numerics)."""
        height, width, channels = image.shape
        is_sobel = filter_name == "sobel"
        served = {1: 1, 2: 2, 4: 1}[lvl] if is_sobel else 2
        mesh = make_mesh(n, dp=1, sp=n, devices=list(self.mesh_devices))
        step = make_sharded_filter(mesh, filter_name, radius=radius,
                                   level=served)
        h_target = spatial_h_target(height, n, filter_name, radius)
        img4 = image[None]
        if h_target != height:
            img4 = np.pad(img4, ((0, 0), (0, h_target - height), (0, 0), (0, 0)),
                          mode="edge")
        blocks = step.shard(torch.from_numpy(img4))
        weights = (gaussian_kernel_f32(radius, float(sigma))
                   if filter_name == "gaussian" else None)

        def finish(out) -> np.ndarray:
            img = step.gather(out, torch.device("cpu")).numpy()[0, :height]
            if is_sobel and h_target != height:
                # The padded rows made the true bottom border interior; every
                # border pixel of the reference is zero, so zeroing all four
                # sides is exact.
                img = _zero_true_border(np.ascontiguousarray(img))
            return img

        key = ("spatial", filter_name, served, height, width, channels,
               None if is_sobel else radius, n)
        return _Call(key, lambda: step.step(blocks, weights),
                     mesh.distinct_devices(), finish, f"spatial(sp={n})",
                     served)

    def _batch_call(self, filter_name: str, images: np.ndarray, level: int,
                    sigma: float, radius: int) -> _Call:
        """The prepared call of a (B, H, W, C) stack: one launch a
        kernel on the runtime's device, or with the mesh-batch switch on,
        the batch padded on the host to a multiple of the mesh's devices
        and one launch a kernel on each device's block
        (dispatch.py:1505-1548 there)."""
        if images.ndim != 4:
            raise ValidationError("Batch input must be 4D (batch, H, W, C)")
        batch = int(images.shape[0])
        if batch < 1:
            raise ValidationError("Batch must contain at least one image")
        height, width, channels = validate_image_shape(images.shape[1:])
        lvl = self._validate(filter_name, level, sigma, radius)
        host = np.require(images, np.uint8, ["C", "W"]).reshape(batch, height, -1)
        shape = (batch, height, width, channels)
        n = self._mesh_batch_n()
        if not n:
            key = batch_cache_key(filter_name, lvl, batch, height, width,
                                  channels, radius,
                                  _taps(filter_name, sigma, radius),
                                  self.device)
            return self._executable_call(key, filter_name, lvl, sigma, radius,
                                         host, shape, "batch")
        key = (filter_name, lvl, batch, height, width, channels, radius)
        if batch % n:
            host = np.concatenate([host, np.repeat(host[-1:], -batch % n, 0)])
        mesh = make_mesh(n, dp=n, sp=1, devices=list(self.mesh_devices))
        devices = mesh.devices.ravel().tolist()
        taps = _taps(filter_name, sigma, radius)
        fns = {d: cuda_api.rows_function(filter_name, lvl, radius, channels,
                                         width, taps, d)
               for d in mesh.distinct_devices()}
        per = host.shape[0] // n
        blocks = [torch.from_numpy(host[i * per:(i + 1) * per]).to(d)
                  for i, d in enumerate(devices)]
        return _Call(
            ("mesh_batch", *key, n),
            lambda: [fns[d](blk) for d, blk in zip(devices, blocks)],
            mesh.distinct_devices(),
            lambda outs: torch.cat([o.cpu() for o in outs])[:batch].numpy()
            .reshape(shape), f"batch(dp={n})", lvl)

    def _run_one(self, filter_name: str, image: np.ndarray, level: int,
                 sigma: float = config.DEFAULT_SIGMA,
                 radius: int = config.DEFAULT_RADIUS, mesh: bool = True,
                 ) -> tuple[np.ndarray, PerformanceMetrics]:
        with spans.request("runtime.call"):
            call = self._single_call(filter_name, image, level, sigma, radius,
                                     mesh)
            with call.staged():
                out, ms = self._timed(call)
                result = call.finish(out)
        height, width, channels = image.shape
        return result, compute_metrics(
            ms, width, height, channels, FILTERS[filter_name].bytes_factor)

    def launch_once(self, filter_name: str, image: np.ndarray, level: int,
                    sigma: float = config.DEFAULT_SIGMA,
                    radius: int = config.DEFAULT_RADIUS) -> np.ndarray:
        """The served function of one (H, W, C) image on the runtime's
        device, run once, eagerly and untimed, holding the card: it builds
        and loads the kernels, and builds no executable (the server's
        start-up warm)."""
        height, width, channels = validate_image_shape(image.shape)
        lvl = self._validate(filter_name, level, sigma, radius)
        rows = torch.from_numpy(
            np.ascontiguousarray(image, np.uint8).reshape(height, -1))
        with exclusive((self.device,)):
            fn = cuda_api.rows_function(filter_name, lvl, radius, channels,
                                        width, _taps(filter_name, sigma, radius),
                                        self.device)
            out = fn(rows.to(self.device)).cpu()
        return out.numpy().reshape(height, width, channels)

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
        """Every requested level of one filter, one after another, on the
        runtime's device (row-sharded serving does not apply, as the JAX
        package's fused all-levels program stays on one chip).  Raises if
        any level fails."""
        _check_filter(filter_name)
        return {lv: self._run_one(filter_name, image, lv, sigma, radius,
                                  mesh=False)
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
        with spans.request("runtime.call"):
            call = self._batch_call(filter_name, images, level, sigma, radius)
            with call.staged():
                out, ms = self._timed(call)
                result = call.finish(out)
        batch, height, width, channels = images.shape
        metrics = compute_metrics(ms, width, height, channels * batch,
                                  FILTERS[filter_name].bytes_factor)
        metrics.fps = batch * 1000.0 / max(metrics.time_ms, 1e-6)
        return result, metrics
