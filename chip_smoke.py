#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each of which fails the run on its own:

1. device: CUDA present, compute capability 9.0; prints the card, its power
   limit and the toolchain;
2. build: builds every library of the main path from the sources, one
   compiler a library, all started together: nvcc for the kernels, the
   host C++ compiler for the codec's library (native/src/gip_codec.cpp,
   gip_jpeg.cpp and gip_formats.cpp, linked with zlib: PNG, the upload
   decoders, the file writers) and phase 10's load generator
   (native/tools/loadgen.cpp); prints the codec library's sources and
   seconds;
3. kernel vs plain: each of the eleven launchers against its plain torch
   version on the card, at small shapes, edge shapes and the full 2146x3239
   RGB image, gaussian at r in {1, 2, 3, 15, 31} and the rows gaussian
   also at r = 20 (its kernel that takes the radius at run time), box also
   at r = 7 and 8 (the last of its window mode, the first of its running
   sums), 64 (the widest of the one-launch running sum), 65 (the first of
   the two-launch one) and 4000 (wider than every image); every kernel must agree exactly,
   except colour level-2 Sobel, held to the bound of
   tests/sobel_tolerance.py, and the tensor-core band, held to maxdiff <= 1
   on at most 0.1% of bytes (its differing bytes are printed) and to the
   same bits on a second launch.  Every launcher also runs on batches (3
   small images, 4 full-size ones) at the server's radii, which must agree
   with its plain version on the same batch and equal its single-image
   launches; the rows gaussian launched from three threads at once with
   three tables, each launch equal to its own plain version;
   the zlib tier's PNG decode through gip_png_decode16 against its plain
   path (`_png_samples`, `unfilter_plain`), and gip_png_decode against
   the plain path's high bytes, on small PNGs of every colour type and
   depth whose rows take the five filter types in turn; the
   upload decoders on the committed fixtures (tests/data/torch_formats:
   JPEG 4:2:0, 4:4:4 and grey, GIF, BMP, PSD, HDR, PIC, PNM, TGA and 1-,
   4-, 16-bit and interlaced PNG) against the pixels the JAX package
   decoded from them, exactly; and the level-2 API on a small image against
   the numpy oracle;
4. API path: the `gpu_filters` API and `run_all_levels` on the full image
   through FilterRuntime(cuda), with its kernels' launch counts read around
   that run; then a torch.profiler trace of the model's forward, which must
   list the rows kernel alone, and a Chrome trace of one API call
   (`capture_trace`), which must show the gaussian kernel;
5. server path: the REST server on 127.0.0.1 in a thread, driven with
   urllib at full size: /api/process-all and /api/process at level 4 on a
   PNG filtered row by row as common encoders do it; the same scene as a
   JPEG (the port's encoder, quality 90) on /api/process-all for each
   filter and /api/process at levels 1, 2 and 4, whose original must be
   the upload passed through, whose levels must agree with each other and
   with the API on the decoded pixels, and which `decode_tiers` must count;
   /api/process-all with `enable_profiling` for each filter, whose level-2
   profile must list the hand kernels alone and whose gaussian L2 profiled
   time must be within 15% of `time_ms`; /api/process-batch with 4 images
   at levels 2 and 4 (one profiled), an error probe; the six rows kernels'
   launch counts read around that run, each request's wall split into
   decode, run, encode and profile;
6. planar path: (a) the models (`GaussianBlur`, `BoxBlur`,
   `SobelEdgeDetection`, an `nn.Sequential` of two), the six registry
   keys and `entry()` on the full image on the card, each equal to the
   interleaved API's result (the level-4 band within its tolerance, since
   the tensor cores sum planes and rows in other orders); the tier runs
   the rows kernels on the (H, W*C) view, so their launch counts, read
   around that run, must move and no planar kernel may launch; (b) the
   planes path, K5 and K7 where the rows kernels do not serve: row bands
   with halo rows, the Sobel batch with zero_rows=False and 33-channel
   images past the rows kernels' caps, against the API's rows and the
   plain versions, with the planar kernels' launch counts read around
   that run (they also run in phase 3 against their plain versions, on
   batches of 4 full-size images and on row bands with halo rows); then a
   torch.profiler trace of both paths that must list every kernel;
7. times: each kernel's CUDA-event time beside its plain version's and
   its bound, the gaussian (r = 1, 15, 20, 31; folded r = 1), box and the
   band at their other radii, K5 and K7 on 4 images and in their halo
   modes, the API's `time_ms` beside its kernel's event time (level 1
   beside the plain version's), and the models' forward wall and events.
   The old kernels against the new: `tools/kernel_times.py --ref`;
7b. served through the executables: every answer phases 4 and 5 served
   (the API at levels 1, 2 and 4 of each filter, process at level 4, the
   batches of 4), served again until its key's graph serves it (a key's
   first request runs eagerly on its staging, its second captures), both
   answers against an eager launch of the same function on the same
   pixels, byte for byte, and each process-all of the graph server below
   against the eager server's; the API call wall on three runtimes in
   turn: eager (as the runtime served before its executables: pageable
   copies, eager launches; a class of this script), staged (executables
   given their pinned staging and no graph: eager launches on it) and
   graph; the graph's wall with its staging in chunks of 1, 2, 4 and 8 MiB
   and whole (`executable.STAGE_CHUNK`); one graph request's steps; the server's run phase a warm
   process-all on the three, and a cold one (a fresh upload size and a
   fresh sigma, so both of its keys are new) on the eager server, the
   graph server and one that captures on a key's first request; loadgen
   on both payloads (the built-in 1x1 PNG and a 3239x2146 PNG) on the
   eager and graph servers, each round's launches, the share of the graph
   server's requests that found their key held, and its executables
   after each load, which must not grow over a repeated one; a profiled
   request of each filter through its graph (`check_launches` must
   pass); each held key's capture ms, pool and launches a replay, and the
   cache's pinned and device bytes;
8. multi-device path: 4 shards on the one card (a mesh may name one device
   several times), meshes (dp, sp) = (2, 2) and (1, 4): `make_sharded_filter`
   for gaussian r = 3, box r = 5 and Sobel L2 and L1 on 1, 4 and 3 full-size
   images (3 leaves H = 2146 uneven over sp = 4), each equal to the
   single-device API and to the plain bodies bit for bit, K5 and K6 one
   launch a shard in their halo modes (counts read around it); row-sharded
   serving (`GIP_TPU_MESH_SPATIAL=1`) through
   `FilterRuntime(cuda, mesh_devices=[cuda:0] * 4)`, gaussian L1/L2/L4, box,
   Sobel L1/L2/L4 against single-device serving (gaussian L4 equals L2), and
   the mesh batch (`GIP_TPU_MESH_BATCH=1`) of 4 images at L2 and L4 against
   the one-device batch, each path's launch counts read around it, a
   profiled request on each (`Serving Path` `spatial(sp=4)`, `batch(dp=4)`,
   the gaussian kernel's name and a time), the switches restored after; sharded `time_ms` and step events beside the
   single-device ones, with the halo bytes; `dryrun_multichip(4)`;
9. host entry points at full size: the native PNG tier's decode of the
   scene equal to the zlib tier's; the image-file CLI
   (`tools/filter_image.py`), its runs in turn in one subprocess, on the
   scene's PNG for
   gaussian, box and Sobel at level 2 and gaussian at level 4, writing
   .png, .ppm, .bmp, .tga (each equal to the API's result), .hdr and .jpg
   (the native writers' bytes, read back), `--load 16` on a 16-bit PNG and
   `--frames` on a 3-frame GIF, its printed lines checked and each run's
   rows-kernel launches read around it; the four examples
   (`gpu_image_processing_tpu_torch/examples/`) on the card in another
   subprocess beside it; the launcher (`tools/serve.py start` on free
   ports, the backend on cuda) starting meanwhile; then the frontend's `/`, the API client (`tools/client.py`, all
   10 checks PASS), a full-size process-all through it (answers decode to
   the API's pixels, `decode_tiers.native_png` counts every PNG upload),
   and `stop`, after which no process of it is alive and both ports are
   free;
10. the verification tier: `tools/silicon_ci.py`, all four stages, in one
   subprocess, each stage in a process of its own: the validation matrix
   (every filter x level x channel count against the numpy oracle, the
   level-4 gates, the rows Sobel against the planar one, shapes across the
   kernels' tiles: `TOTAL FAILURES: 0`), the soak (N = 150 random shapes,
   biased to the tile edges, and the planar kernels' routes: `SOAK DONE: 0
   failures`), the speed-of-light report (`--check`: each hand kernel's ms,
   % of its bound and the binding bound at 2146x3239x3, levels 1, 2 and 4)
   and the served stack (the launcher, the client, loadgen on the built-in
   request and on a full-size PNG, with `time_ms` under that load against
   the same request alone); it prints each stage's seconds, the totals, the
   sol table's hand-kernel rows, both loadgen lines, `time_ms` under load
   and each stage's kernel launches, and fails if any stage failed;
11. the installed package: a wheel built offline from a copy of its inputs,
   installed with `--target` and made read-only, run from a directory
   outside the checkout with `XDG_CACHE_HOME` in a temporary directory that
   holds the checkout's kernel libraries alone, and an nvcc on PATH that
   fails: the image-file CLI on the scene's JPEG (gaussian level 2), whose
   PNG must equal the checkout CLI's byte for byte; the launcher's `start
   --no-frontend` and one /api/process-all of that JPEG, whose levels must
   equal the checkout server's answer (phase 5), then `stop` (the
   launcher's code in this process, by its PID file); a `start` with the
   web UI, which must refuse naming `frontend/`; no nvcc may run, the
   codec's library must be built from the install's own copies of its
   three sources under the checkout's name, and nothing may be written under the
   install; it prints each step's seconds.

The line before the last is a JSON object `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`.  Any failure exits non-zero and prints no ok
line, as does a host without CUDA or a directory without the package.
"""

from __future__ import annotations

import base64
import contextlib
import io
import itertools
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn

from gpu_image_processing_tpu_torch.api import filters as api
from gpu_image_processing_tpu_torch.core import config, files
from gpu_image_processing_tpu_torch.entry import dryrun_multichip, entry
from gpu_image_processing_tpu_torch.models import (
    BoxBlur, GaussianBlur, SobelEdgeDetection)
from gpu_image_processing_tpu_torch.ops import fused, interleaved
from gpu_image_processing_tpu_torch.ops.cuda import (
    LAUNCHES, blur, blur_planar, build, sobel, sobel_planar)
from gpu_image_processing_tpu_torch.ops.cuda import api as planar_api
from gpu_image_processing_tpu_torch.ops.weights import (
    bf16_split, gaussian_kernel_f32, weights_to_torch)
from gpu_image_processing_tpu_torch.parallel.mesh import make_mesh
from gpu_image_processing_tpu_torch.parallel.spatial import (
    make_sharded_filter, spatial_halo)
from gpu_image_processing_tpu_torch.profiling.profiler import (
    PEAKS, PRIMER_KERNEL, PRIMERS, capture_trace, primers_kept, profile_batch,
    profile_filter, short_kernel_name, traced)
from gpu_image_processing_tpu_torch.profiling.traffic import least_ms
from gpu_image_processing_tpu_torch.core.params import (
    normalize_level, validate_image_shape)
from gpu_image_processing_tpu_torch.runtime import executable
from gpu_image_processing_tpu_torch.runtime.device import describe
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime, _Call
from gpu_image_processing_tpu_torch.runtime.timing import exclusive
from gpu_image_processing_tpu_torch.server.app import create_app
from gpu_image_processing_tpu_torch.server.http import AppServer
from gpu_image_processing_tpu_torch.tools import serve, silicon_ci
from gpu_image_processing_tpu_torch.utils import image as codec
from gpu_image_processing_tpu_torch.utils import native_codec
from gpu_image_processing_tpu_torch.utils.image import (
    decode_base64_image, decode_png, encode_png)
from tests import oracle_numpy as oracle

FULL = (2146, 3239, 3)        # the README image (bench.py:34,50-52)
SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4), (2, 2, 3), (1, 7, 1), FULL]
GAUSS = [(1, 1.0), (2, 1.5), (3, 2.0), (15, 8.0), (31, 8.0)]   # (radius, sigma)
# The rows gaussian's radii without a kernel of their own (16 to 30 weighted,
# 3 and up folded) share one that takes the radius at run time.
GAUSS_RUNTIME_RADIUS = (20, 8.0)
BOX_RADII = [1, 2, 5, 15, 40]
# box_rows: the widest radius of its window mode and the first of its
# running sums, the widest of its one-launch running sum, the first of its
# two-launch one, and one wider than every image here.
BOX_WIDE_RADII = [7, 8, 64, 65, 4000]
PLANAR_BOX_RADII = [1, 2, 5, 15, 31]   # the planar blur takes r <= 31
BAND_ROWS = (700, 1500)       # a row band of the full image, for the halo modes
MAIN_SIGMA, MAIN_GAUSS_RADIUS, MAIN_BOX_RADIUS = 2.0, 3, 5
FOLDED_RADIUS = 2             # level 4 folds taps below r = 3
SEED = 1234
# tests/sobel_tolerance.py: colour Sobel may differ by <= 6 on <= 0.1% of
# pixels (a grey value on a .5 tie rounds either way under FMA contraction).
SOBEL_MAX_DIFF, SOBEL_MAX_FRACTION = 6, 1e-3
# The server's request-body cap (server/http.py::_max_body_bytes).
BODY_CAP = 64 * 1024 * 1024

# Peaks of one H100 SXM at 700 W, from the profiler's table: device memory
# and dense bf16 on the tensor cores as published; float32 outside the
# tensor cores as these kernels can issue it.  The published 67e12 counts a
# fused multiply-add as two operations (132 SMs x 128 lanes x 2 x 1.98
# GHz); every kernel here builds with -fmad=false and rounds each multiply
# and add on its own (__fmul_rn, __fadd_rn), as the bit-exact contract
# requires, so each operation is one instruction: 132 x 128 x 1.98 GHz.
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
# The upload fixtures (tests/data/torch_formats/generate.py) and the pixels
# the JAX package decoded from them.
FORMAT_FIXTURES = "tests/data/torch_formats"
JPEG_QUALITY = 90

_BLUR = "gpu_image_processing_tpu_torch/ops/cuda/blur.cu"
_SOBEL = "gpu_image_processing_tpu_torch/ops/cuda/sobel.cu"
_TPU = "gpu_image_processing_tpu/ops/pallas/"
KERNELS = {
    "gaussian_rows": {
        "source": _BLUR,
        "replaces": _TPU + "blur.py:212",
        "also_replaces": [_TPU + "blur.py:985"],
        "profiler_names": ["gauss_window_rows<gip::Weighted", "gauss_pair_rows"],
    },
    "box_rows": {
        "source": _BLUR,
        "replaces": _TPU + "blur_mxu.py:190",
        "also_replaces": [_TPU + "blur.py:212", _TPU + "blur.py:996",
                          _TPU + "blur_mxu.py:567"],
        # Small radii take the window kernel in box mode, then running sums
        # in one launch, then two.
        "profiler_names": ["gauss_window_rows<gip::Box", "box_window_rows",
                           "box_wide_h", "box_wide_v"],
    },
    "sobel_rows": {
        "source": _SOBEL,
        "replaces": _TPU + "sobel_mxu.py:174",
        "also_replaces": [_TPU + "sobel.py:162", _TPU + "sobel_mxu.py:299",
                          _TPU + "sobel.py:289"],
        "profiler_names": ["sobel_tile_rows<true, 3, false>"],
    },
    "gaussian_folded_rows": {
        "source": _BLUR,
        "replaces": _TPU + "blur.py:212",
        "also_replaces": [_TPU + "blur.py:318", _TPU + "blur.py:985"],
        "profiler_names": ["gauss_window_rows<gip::Folded"],
    },
    "gaussian_band_rows": {
        "source": _BLUR,
        "replaces": _TPU + "blur_mxu.py:190",
        "also_replaces": [_TPU + "blur_mxu.py:506", _TPU + "blur_mxu.py:518"],
        "profiler_names": ["band_mma_rows"],
    },
    "sobel_f32_rows": {
        "source": _SOBEL,
        "replaces": _TPU + "sobel_mxu.py:174",
        "also_replaces": [_TPU + "sobel.py:162", _TPU + "sobel_mxu.py:364",
                          _TPU + "sobel_mxu.py:299", _TPU + "sobel.py:289"],
        "profiler_names": ["sobel_tile_rows<false, 3, false>"],
    },
    # The planar blur (K5) and Sobel (K7): the rows templates at one
    # channel a plane (gauss_window_rows, box_window_rows, with halo rows)
    # and in their planar layout (sobel_tile_rows<.., true>).
    "gaussian_planar": {
        "source": _BLUR,
        "replaces": _TPU + "blur.py:664",
        "also_replaces": [_TPU + "blur.py:212", _TPU + "blur.py:1055"],
        "profiler_names": ["gauss_window_rows<gip::Weighted", "gauss_pair_rows"],
    },
    "gaussian_folded_planar": {
        "source": _BLUR,
        "replaces": _TPU + "blur.py:664",
        "also_replaces": [_TPU + "blur.py:318", _TPU + "blur.py:1055"],
        "profiler_names": ["gauss_window_rows<gip::Folded"],
    },
    "box_planar": {
        "source": _BLUR,
        "replaces": _TPU + "blur.py:664",
        "also_replaces": [_TPU + "blur.py:1075", _TPU + "blur_mxu.py:544"],
        "profiler_names": ["gauss_window_rows<gip::Box", "box_window_rows"],
    },
    "sobel_planar": {
        "source": _SOBEL,
        "replaces": _TPU + "sobel.py:121",
        "also_replaces": [_TPU + "sobel.py:143"],
        "profiler_names": ["sobel_tile_rows<true, 3, true>"],
    },
    "sobel_f32_planar": {
        "source": _SOBEL,
        "replaces": _TPU + "sobel.py:121",
        "also_replaces": [_TPU + "sobel.py:143"],
        "profiler_names": ["sobel_tile_rows<false, 3, true>"],
    },
}
# Kernels of the API path (phase 4); the server path runs the first six, and
# so does the planar tier (phase 6a), on the (H, W*C) view of each image.
API_KERNELS = ("gaussian_rows", "box_rows", "sobel_rows")
ROWS_KERNELS = tuple(KERNELS)[:6]
# The planar kernels (K5, K7), launched on the planes path (phase 6b): row
# bands with halo rows, the Sobel batch with zero_rows=False, and images
# past the rows kernels' channel caps.
PLANAR_KERNELS = tuple(KERNELS)[6:]


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def absdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int32) - b.to(torch.int32)).abs()


def launchers(dev: torch.device, radius: int, sigma: float, box_radius: int,
              width: int, channels: int) -> dict:
    """name -> (kernel, plain) functions of rows, for one parameter set."""
    table = gaussian_kernel_f32(radius, sigma)
    w = weights_to_torch(table, dev)
    # The rows gaussian takes its taps by value, from the host.
    w_host = weights_to_torch(table, torch.device("cpu"))
    hi, lo = (weights_to_torch(t, dev) for t in bf16_split(table))
    r, br, c = radius, box_radius, channels
    return {
        "gaussian_rows": (lambda x: blur.gaussian_rows(x, w_host, r, c),
                          lambda x: blur.gaussian_rows_plain(x, w, r, c)),
        "gaussian_folded_rows": (
            lambda x: blur.gaussian_folded_rows(x, w_host, r, c),
            lambda x: blur.gaussian_folded_rows_plain(x, w, r, c)),
        "gaussian_band_rows": (
            lambda x: blur.gaussian_band_rows(x, hi, lo, r, c),
            lambda x: blur.gaussian_band_rows_plain(x, hi, lo, r, c)),
        "box_rows": (lambda x: blur.box_rows(x, br, c),
                     lambda x: blur.box_rows_plain(x, br, c)),
        "sobel_rows": (lambda x: sobel.sobel_rows(x, width, c),
                       lambda x: sobel.sobel_rows_plain(x, width, c)),
        "sobel_f32_rows": (lambda x: sobel.sobel_f32_rows(x, width, c),
                           lambda x: sobel.sobel_f32_rows_plain(x, width, c)),
    }


def planar_launchers(dev: torch.device, radius: int, sigma: float,
                     box_radius: int) -> dict:
    """name -> (kernel, plain) functions of (N, H, W) or (B, C, H, W)
    planes, for one parameter set."""
    table = gaussian_kernel_f32(radius, sigma)
    w = weights_to_torch(table, dev)
    # The planar gaussian takes its taps by value, from the host.
    w_host = weights_to_torch(table, torch.device("cpu"))
    r, br = radius, box_radius
    return {
        "gaussian_planar": (lambda x: blur_planar.gaussian_planar(x, w_host, r),
                            lambda x: blur_planar.gaussian_planar_plain(x, w, r)),
        "gaussian_folded_planar": (
            lambda x: blur_planar.gaussian_folded_planar(x, w_host, r),
            lambda x: blur_planar.gaussian_folded_planar_plain(x, w, r)),
        "box_planar": (lambda x: blur_planar.box_planar(x, br),
                       lambda x: blur_planar.box_planar_plain(x, br)),
        "sobel_planar": (sobel_planar.sobel_planar,
                         lambda x: sobel_planar.sobel_planar_plain(x, 2)),
        "sobel_f32_planar": (sobel_planar.sobel_f32_planar,
                             lambda x: sobel_planar.sobel_planar_plain(x, 1)),
    }


def bound(name: str, shape: tuple[int, ...], radius: int) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations") for one launch on
    (..., H, W, C) uint8 at the peaks above: the package's model
    (profiling/traffic.py::least_ms), each input byte read once and each
    output byte written once against the operations the function needs."""
    return least_ms(name, shape, radius, H100)


def scene_image(rng: np.random.Generator) -> np.ndarray:
    """A full-size RGB scene of the dead-leaves model of natural-image
    statistics: occluding discs with radii of density r^-3 (3 to 1200
    pixels), a 1/f texture over them and sensor noise.  Its PNG is about
    70% of the raw bytes and holds every scanline filter type."""
    h, w, _ = FULL
    img = np.empty(FULL, np.float32)
    img[:] = rng.uniform(0, 255, 3)
    n = h * w // 145
    rmin, rmax = 3.0, 1200.0
    radii = 1 / np.sqrt(1 / rmin**2 - rng.uniform(size=n) * (1 / rmin**2 - 1 / rmax**2))
    for r, cy, cx, col in zip(radii, rng.uniform(0, h, n), rng.uniform(0, w, n),
                              rng.uniform(0, 255, (n, 3)).astype(np.float32)):
        y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, h)
        x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, w)
        yy = np.arange(y0, y1)[:, None] - cy
        xx = np.arange(x0, x1)[None, :] - cx
        img[y0:y1, x0:x1][yy * yy + xx * xx <= r * r] = col
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    spec = (rng.standard_normal(f.shape) + 1j * rng.standard_normal(f.shape)) / f
    spec[0, 0] = 0
    texture = np.fft.irfft2(spec, s=(h, w))
    img += (12 / texture.std() * texture).astype(np.float32)[:, :, None]
    img += rng.normal(0, 2.0, FULL).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def filter_predictions(x: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, row bytes) int16: the predictions of the five PNG filters
    (None, Sub, Up, Average, Paeth) for packed rows `x` (int16), `bpp`
    bytes a filter unit."""
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    return np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])


def png_file(lines: np.ndarray, width: int, depth: int, colour: int,
             extra=()) -> bytes:
    """PNG bytes of filtered scanlines (H, 1 + row bytes), zlib level 6,
    the chunks of `extra` ((type, payload) pairs) before IDAT."""
    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", width, len(lines), depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + b"".join(chunk(k, v) for k, v in extra)
            + chunk(b"IDAT", zlib.compress(lines.tobytes(), 6))
            + chunk(b"IEND", b""))


def client_png(img: np.ndarray) -> tuple[bytes, dict[int, int]]:
    """(PNG bytes, rows per filter type) of an (H, W, 3) image as libpng and
    Pillow write it by default: each row's filter (None, Sub, Up, Average or
    Paeth) chosen by the least sum of absolute signed residuals, the PNG
    specification's heuristic, then zlib level 6."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    lines = np.empty((h, w * c + 1), np.uint8)
    best = None
    for kind, pred in enumerate(filter_predictions(x, c)):
        res = ((x - pred) & 0xFF).astype(np.uint8)
        cost = np.abs(res.view(np.int8).astype(np.int32)).sum(axis=1)
        take = np.ones(h, bool) if best is None else cost < best
        best = cost if best is None else np.where(take, cost, best)
        lines[take, 0] = kind
        lines[take, 1:] = res[take]
    kinds, counts = np.unique(lines[:, 0], return_counts=True)
    return png_file(lines, w, 8, 2), dict(zip(kinds.tolist(), counts.tolist()))


def cycled_png(values: np.ndarray, depth: int, colour: int, extra=()) -> bytes:
    """PNG bytes of (H, W, S) sample values at `depth` bits whose row k is
    filtered by type k % 5 (None, Sub, Up, Average, Paeth)."""
    h, w, samples = values.shape
    if depth == 16:
        packed = values.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        packed = values.astype(np.uint8).reshape(h, -1)
    else:
        bits = (values[..., :1] >> np.arange(depth - 1, -1, -1)) & 1
        packed = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    x = packed.astype(np.int16)
    kinds = np.arange(h) % 5
    pred = filter_predictions(x, max(1, samples * depth // 8))[kinds, np.arange(h)]
    lines = np.empty((h, x.shape[1] + 1), np.uint8)
    lines[:, 0] = kinds
    lines[:, 1:] = (x - pred) & 0xFF
    return png_file(lines, w, depth, colour, extra)


def gradient_image(rng: np.random.Generator, k: int) -> np.ndarray:
    """A full-size RGB gradient with low noise (2 bits a sample), which
    compresses far better than a scene, so that four fit the body cap."""
    h, w, _ = FULL
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    slope = np.array([150, 90, -120], np.float32) * (1 + 0.2 * k)
    base = 40 + 20 * k + x * slope + y * slope[::-1] * 0.5
    noise = rng.integers(0, 4, FULL)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


class Client:
    """urllib against the server on 127.0.0.1 (proxies off), with each
    request's wall and the server's decode/run/encode split."""

    def __init__(self, base: str, card: str):
        self.base = base
        self.card = card
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def _call(self, path: str, body: bytes | None = None) -> tuple[int, dict]:
        req = urllib.request.Request(
            self.base + path, data=body,
            headers={"Content-Type": "application/json"} if body else {})
        try:
            with self.opener.open(req, timeout=300) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    def get(self, path: str) -> tuple[int, dict]:
        return self._call(path)

    def post(self, path: str, payload: dict, label: str) -> tuple[int, dict]:
        body = json.dumps(payload).encode()
        before = self._call("/api/stats")[1]["phase_ms"].get(f"POST {path}", {})
        t0 = time.perf_counter()
        status, out = self._call(path, body)
        wall = (time.perf_counter() - t0) * 1000.0
        after = self._call("/api/stats")[1]["phase_ms"].get(f"POST {path}", {})
        split = ", ".join(f"{p} {after.get(p, 0.0) - before.get(p, 0.0):.1f}"
                          for p in ("decode", "run", "encode", "profile"))
        print(f"[{self.card}] request {path} {label}: status {status}, body "
              f"{len(body) / 1e6:.2f} MB, wall {wall:.1f} ms (server: {split} "
              f"ms; host clock)")
        return status, out


# -- phase 7b: served through the executables' graphs ------------------------

class EagerRuntime(FilterRuntime):
    """The runtime as it served one device before its executables: the rows
    copied to the card from pageable memory on every request, the rows
    function launched eagerly, the answer copied back.  The yardstick of
    phase 7b's walls only: the port serves through its executables."""

    def _eager_call(self, filter_name: str, lvl: int, sigma: float,
                    radius: int, host: np.ndarray, shape: tuple[int, ...],
                    path: str) -> _Call:
        fn = planar_api.rows_function(
            filter_name, lvl, radius, shape[-1], shape[-2],
            gaussian_kernel_f32(radius, sigma) if filter_name == "gaussian"
            else None, self.device)
        rows = torch.from_numpy(host).to(self.device)
        batch = shape[0] if len(shape) == 4 else 1
        return _Call((filter_name, lvl, batch, *shape[-3:], radius),
                     lambda: fn(rows), (self.device,),
                     lambda out: out.cpu().numpy().reshape(shape), path, lvl)

    def _single_call(self, filter_name, image, level, sigma, radius, mesh=True):
        height = validate_image_shape(image.shape)[0]
        lvl = self._validate(filter_name, level, sigma, radius)
        host = np.require(image, np.uint8, ["C", "W"]).reshape(height, -1)
        return self._eager_call(filter_name, lvl, sigma, radius, host,
                                image.shape, "single_image")

    def _batch_call(self, filter_name, images, level, sigma, radius):
        batch, height = images.shape[:2]
        validate_image_shape(images.shape[1:])
        lvl = self._validate(filter_name, level, sigma, radius)
        host = np.require(images, np.uint8, ["C", "W"]).reshape(batch, height, -1)
        return self._eager_call(filter_name, lvl, sigma, radius, host,
                                images.shape, "batch")


def eager_answer(rt: FilterRuntime, f: str, lv: int, imgs: np.ndarray,
                 sigma: float = MAIN_SIGMA, radius: int | None = None) -> np.ndarray:
    """The served function of (H, W, C) or (B, H, W, C) images launched
    eagerly on the card, holding it, as the runtime ran it before its
    executables."""
    radius = radius or {"gaussian": MAIN_GAUSS_RADIUS, "box": MAIN_BOX_RADIUS}.get(f, 3)
    fn = planar_api.rows_function(
        f, normalize_level(f, lv), radius, imgs.shape[-1], imgs.shape[-2],
        gaussian_kernel_f32(radius, sigma) if f == "gaussian" else None,
        rt.device)
    rows = torch.from_numpy(np.ascontiguousarray(imgs).reshape(
        *imgs.shape[:-2], -1)).to(rt.device)
    with exclusive([rt.device]):
        return fn(rows).cpu().numpy().reshape(imgs.shape)


def run_loadgen(port: int, load: tuple[int, int], payload: str | None,
                endpoint: str | None) -> dict[str, float]:
    """loadgen's numbers against the server on 127.0.0.1:`port`."""
    cmd = [str(build.build_loadgen()), "127.0.0.1", str(port), *map(str, load)]
    if payload:
        cmd += [payload, endpoint]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    out = silicon_ci.parse_loadgen(proc.stdout + proc.stderr)
    require(proc.returncode == 0 and out.get("ok") and out.get("failed") == 0,
            f"loadgen {load}: exit {proc.returncode}, {out}\n{proc.stdout[-1000:]}")
    return out


def executables_line(rt: FilterRuntime) -> str:
    """Each held executable: its key's shape, its requests, and its graph's
    capture ms, pool and launches a replay."""
    parts = []
    for exe in rt.executables.values():
        k = exe.key
        batch = k[0] == "batch"
        f, lvl, b, h, w, c, r = k[1:8] if batch else k[:7]
        graph = (f"capture {exe.capture_ms:.1f} ms, pool "
                 f"{exe.pool_bytes / 1e6:.1f} MB, {dict(exe.launches)} a replay"
                 if exe.captured else "no graph")
        parts.append(f"{f} L{lvl} {b}x{h}x{w}x{c}" + (f" r={r}" if r else "")
                     + f": {exe.requests} requests, {graph}")
    return "; ".join(parts)


@contextlib.contextmanager
def capture_at(n: int):
    """Executables made meanwhile capture their graph on request `n`."""
    old, executable.CAPTURE_AT = executable.CAPTURE_AT, n
    try:
        yield
    finally:
        executable.CAPTURE_AT = old


def through_graph(rt: FilterRuntime, serve, what: str) -> list[np.ndarray]:
    """`serve()`'s answers until its key's graph has served one (a key's
    first request runs eagerly, its second captures): the last answer came
    through the graph."""
    answers = []
    for _ in range(executable.CAPTURE_AT):
        answers.append(serve())
        exe = rt.executables.values()[-1]   # the one that served
        if exe.captured:
            return answers
    require(False, f"{what}: no graph served request {exe.requests} of its key")


def graph_phase(rt: FilterRuntime, card: str, image: np.ndarray,
                scene: np.ndarray, scene_b64: str, grads: list[np.ndarray],
                served: dict, served4: dict, batches: dict) -> None:
    """Phase 7b: the answers the executables served (phases 4 and 5), and
    the same requests served again through their graphs, against eager
    launches of the same functions at full size, byte for byte; the API
    call wall, eager, staged and through the graphs, in turn; the server's
    run phase warm and cold, and loadgen on both payloads; a profiled
    request through the graph; each key's capture and what the cache
    holds."""
    t7b = time.perf_counter()
    h, w, c = FULL
    eager_rt = EagerRuntime(rt.device)
    calls = {
        "gaussian": lambda r, lv: api.gaussian_blur(
            image, MAIN_SIGMA, MAIN_GAUSS_RADIUS, lv, runtime=r),
        "box": lambda r, lv: api.box_blur(image, MAIN_BOX_RADIUS, lv, runtime=r),
        "sobel": lambda r, lv: api.sobel_edge_detection(image, lv, runtime=r),
    }
    # The API path: every filter and level, staged and graph against eager.
    for f in calls:
        for lv in config.REQUEST_LEVELS:
            want = eager_answer(rt, f, lv, image)
            for got in through_graph(rt, lambda: calls[f](rt, lv)["image"],
                                     f"API {f} L{lv}"):
                require(np.array_equal(got, want),
                        f"API {f} L{lv}: the executable's answer differs from "
                        f"an eager launch")
            require(np.array_equal(calls[f](eager_rt, lv)["image"], want),
                    f"API {f} L{lv}: the eager runtime's answer differs")
    # The server path (phase 5): process-all L1/L2 and process L4 on the
    # scene, and the batches of 4 gradients at L2 and L4, each as phase 5
    # served it and again through its graph.
    for (f, lv), got in served.items():
        require(np.array_equal(got, eager_answer(rt, f, lv, scene)),
                f"served process-all {f} L{lv} differs from an eager launch")
    sigma_of = {2: 1.5, 3: MAIN_SIGMA, 15: 5.0}
    for (f, radius), got in served4.items():
        sigma = sigma_of.get(radius, MAIN_SIGMA)
        want = eager_answer(rt, f, 4, scene, sigma, radius)
        again = through_graph(rt, lambda: rt.run(
            f, scene, level=4, sigma=sigma,
            radius=radius or config.DEFAULT_RADIUS)[0], f"process {f} L4")
        require(all(np.array_equal(a, want) for a in [got, *again]),
                f"served process {f} L4 r={radius} differs from an eager launch")
    stack = np.stack(grads)
    for (f, lv), got in batches.items():
        want = eager_answer(rt, f, lv, stack)
        radius = {"gaussian": MAIN_GAUSS_RADIUS, "box": MAIN_BOX_RADIUS}.get(
            f, config.DEFAULT_RADIUS)
        again = through_graph(rt, lambda: rt.run_batch(
            f, stack, level=lv, sigma=MAIN_SIGMA, radius=radius)[0],
            f"process-batch {f} L{lv}")
        require(all(np.array_equal(a, want) for a in [np.stack(got), *again]),
                f"served process-batch {f} L{lv} differs from an eager launch")
    print(f"executables vs eager at {w}x{h}x{c}: API {len(calls) * 3} answers "
          f"(3 filters x L1/L2/L4), server {len(served)} process-all, "
          f"{len(served4)} process L4, {len(batches)} batches of 4, as served "
          f"and again through their graphs: all equal byte for byte")

    # The API call wall (host clock, copies included), least and median of
    # 5 in turn: eager, staged (eager launches on executables given their
    # pinned staging and no graph) and the graph.
    staged_rt = FilterRuntime(rt.device)   # pinned staging, never a graph
    for f, lv in itertools.product(calls, (1, 2)):   # builds the executables
        with capture_at(sys.maxsize):
            calls[f](staged_rt, lv)
        staged_rt.executables.values()[-1]._buffers(staging=True)
        through_graph(rt, lambda: calls[f](rt, lv)["image"], f"API {f} L{lv}")
    arms = {"eager": eager_rt, "staged": staged_rt, "graph": rt}
    for lv, f in itertools.product((2, 1), calls):
        walls = {label: [] for label in arms}
        time_ms = {label: [] for label in arms}
        for _ in range(5):
            for label, r in arms.items():
                t0 = time.perf_counter()
                res = calls[f](r, lv)
                walls[label].append((time.perf_counter() - t0) * 1000.0)
                time_ms[label].append(res["time_ms"])
                if label != "eager":
                    require(r.executables.values()[-1].captured == (label == "graph"),
                            f"{label} {f} L{lv}: served {'without' if label == 'graph' else 'with'} a graph")
        print(f"[{card}] {f} L{lv} {w}x{h}x{c}: API call wall (host clock, least "
              f"/ median of 5, in turn) " + ", ".join(
                  f"{label} {min(v):.3f} / {float(np.median(v)):.3f} ms"
                  for label, v in walls.items())
              + "; time_ms " + ", ".join(f"{label} {min(v):.4f}"
                                         for label, v in time_ms.items()))
    # The staging's chunk (`executable.STAGE_CHUNK`): the graph's API call
    # wall, least and median of 5 in turn, on runtimes whose executables
    # stage in chunks of 1, 2, 4 and 8 MiB, and whole.
    sweep = {}
    for label, size in ({f"{n} MiB": n << 20 for n in (1, 2, 4, 8)}
                        | {"whole": 1 << 40}).items():
        sweep[label] = FilterRuntime(rt.device)
        old, executable.STAGE_CHUNK = executable.STAGE_CHUNK, size
        try:
            for f, lv in (("gaussian", 2), ("sobel", 1)):
                through_graph(sweep[label], lambda: calls[f](sweep[label], lv)["image"],
                              f"API {f} L{lv}, staging {label}")
        finally:
            executable.STAGE_CHUNK = old
    for f, lv in (("gaussian", 2), ("sobel", 1)):
        walls = {label: [] for label in sweep}
        for _ in range(5):
            for label, r in sweep.items():
                t0 = time.perf_counter()
                calls[f](r, lv)
                walls[label].append((time.perf_counter() - t0) * 1000.0)
        print(f"[{card}] {f} L{lv} {w}x{h}x{c}: the graph's API call wall by "
              f"staging chunk (host clock, least / median of 5, in turn) "
              + ", ".join(f"{label} {min(v):.3f} / {float(np.median(v)):.3f} ms"
                          for label, v in walls.items()))
    del sweep
    # One graph request in its steps, host clock, least of 5: the staging
    # in (host copy and copy to the card), the replay, the copy out (copy
    # from the card and host copy into a new array); and a plain host copy
    # of the image into an array already written.
    rows_h = image.reshape(h, -1)
    exe = next(e for e in rt.executables.values()
               if e.key[:3] == ("gaussian", 2, 1) and e.shape == rows_h.shape)
    steps = {"stage": [], "replay": [], "fetch": [], "host copy": []}
    warm = np.empty_like(rows_h)
    for _ in range(5):
        t0 = time.perf_counter()
        with exe.staged(rows_h):
            torch.cuda.current_stream(rt.device).synchronize()
            t1 = time.perf_counter()
            with exclusive([rt.device]):
                out = exe.run()
                torch.cuda.current_stream(rt.device).synchronize()
            t2 = time.perf_counter()
            exe.fetch(out)
            t3 = time.perf_counter()
        np.copyto(warm, rows_h)
        t4 = time.perf_counter()
        for k, a, b in (("stage", t0, t1), ("replay", t1, t2), ("fetch", t2, t3),
                        ("host copy", t3, t4)):
            steps[k].append((b - a) * 1000.0)
    print(f"[{card}] one gaussian L2 graph request at {w}x{h}x{c}, ms (host "
          f"clock, least of 5): " + ", ".join(f"{k} {min(v):.3f}"
                                              for k, v in steps.items()))

    # The server: its run phase a warm and a cold process-all, and
    # loadgen's two payloads, on servers in this process.
    work = tempfile.mkdtemp(prefix="chip_smoke_7b_")
    payload_file = os.path.join(work, "full_payload.json")
    with open(payload_file, "w") as fh:
        json.dump(silicon_ci.full_size_payload(), fh)
    first_rt = FilterRuntime(rt.device)
    servers = {"eager": AppServer(create_app(eager_rt), "127.0.0.1", 0),
               "staged": AppServer(create_app(staged_rt), "127.0.0.1", 0),
               "graph": AppServer(create_app(rt), "127.0.0.1", 0),
               "capture at first": AppServer(create_app(first_rt), "127.0.0.1", 0)}
    params = {"gaussian": {"sigma": MAIN_SIGMA, "radius": MAIN_GAUSS_RADIUS},
              "box": {"radius": MAIN_BOX_RADIUS}, "sobel": {}}
    route = "POST /api/process-all"
    run_ms, answers, loads, held, launches = {}, {}, {}, {}, {}
    try:
        clients = {}
        for label, server in servers.items():
            server.start_background()
            clients[label] = Client(f"http://127.0.0.1:{server.port}", card)

        # The request of a key that captures its graph, by server.
        capture_of = {"staged": sys.maxsize, "capture at first": 1}

        def run_phase(label: str, payloads: list[dict], what: str) -> float:
            """The server's run phase a request over `payloads`, in ms."""
            client = clients[label]
            before = client.get("/api/stats")[1]["phase_ms"].get(route, {})
            for payload in payloads:
                with capture_at(capture_of.get(label, executable.CAPTURE_AT)):
                    status, out = client.post(
                        "/api/process-all", payload,
                        f"{payload['filter']} {what} {label}")
                require(status == 200, f"{label} process-all {what}: {status}")
                answers.setdefault((label, what, payload["filter"]),
                                   out["results"])
            after = client.get("/api/stats")[1]["phase_ms"][route]
            return ((after["run"] - before.get("run", 0.0))
                    / (after["requests"] - before.get("requests", 0)))

        warm_payloads = [{"image": scene_b64, "filter": f, **params[f]}
                         for f in params]
        for label in ("eager", "staged", "graph", "graph", "staged", "eager"):
            # Untimed: the keys seen and, on the graph server, captured.
            for _ in range(executable.CAPTURE_AT if label == "graph" else 1):
                run_phase(label, warm_payloads, "warm-up")
            torch.cuda.synchronize()
            LAUNCHES.clear()
            run_ms.setdefault(("warm", label), []).append(
                run_phase(label, warm_payloads, "warm"))
            torch.cuda.synchronize()
            launches[label] = {k: n for k, n in LAUNCHES.items() if n}
        require(not any(e.captured for e in staged_rt.executables.values()),
                "the staged server captured a graph")
        graphs = {e.key[:2] for e in rt.executables.values()
                  if e.captured and e.key[3:6] == (h, w, c)}
        require({(f, lv) for f in params for lv in (1, 2)} <= graphs,
                f"the graph server served its warm process-all without graphs: "
                f"it holds graphs of {sorted(graphs)}")
        for f in params:
            eager_out = answers[("eager", "warm", f)]
            for label in ("staged", "graph"):
                require(all(answers[(label, "warm", f)][k]["processed_image"]
                            == eager_out[k]["processed_image"]
                            for k in ("level_1", "level_2")),
                        f"process-all {f}: the {label} server's answer differs "
                        f"from the eager server's")
        # Cold: each request a fresh upload size and a fresh sigma, so both
        # of its keys (L1 and L2) are new to the server that serves it.
        cold = ("eager", "graph", "capture at first")
        for i, label in enumerate(cold * 3):
            crop = np.ascontiguousarray(scene[:h - 8 * (i + 1), :w - 8 * (i + 1)])
            payload = {"image": "data:image/png;base64," + base64.b64encode(
                           native_codec.png_encode(crop)).decode(),
                       "filter": "gaussian", "sigma": 1.05 + 0.1 * i,
                       "radius": MAIN_GAUSS_RADIUS}
            ms = run_phase(label, [payload], f"cold {i}")
            run_ms.setdefault(("cold", label), []).append(ms)
            want = eager_answer(rt, "gaussian", 2, crop, payload["sigma"])
            require(decode_base64_image(answers[(label, f"cold {i}", "gaussian")]
                                        ["level_2"]["processed_image"]).tobytes()
                    == want.tobytes(), f"cold process-all on the {label} server "
                                       f"differs from an eager launch")
        for kind in ("warm", "cold"):
            print(f"[{card}] server run phase, {kind} process-all (L1 + L2) "
                  f"at {w}x{h} ({'gaussian, box and Sobel' if kind == 'warm' else 'gaussian, a fresh size and sigma each'}), "
                  f"ms a request (host clock; rounds in turn): " + "; ".join(
                      f"{label} " + " / ".join(f"{m:.2f}" for m in v)
                      for (k, label), v in run_ms.items() if k == kind))
        print(f"captures on the cold requests of the capture-at-first server: "
              + ", ".join(f"{e.capture_ms:.1f} ms" for e in first_rt.executables.values()))
        print(f"launches for the 3 warm process-all requests of the last round: "
              + ", ".join(f"{label} server {n}" for label, n in launches.items()))
        for label, name in itertools.product(launches, API_KERNELS):
            require(launches[label].get(name, 0) >= config.TIMING_REPS,
                    f"the {label} server launched {name} "
                    f"{launches[label].get(name, 0)} times for one process-all")
        for load, payload, endpoint, order in (
                (silicon_ci.SMALL_LOAD, None, None, ("eager", "graph")),
                (silicon_ci.FULL_LOAD, payload_file, "/api/process-all",
                 ("eager", "graph", "graph"))):
            for label in order:
                port = servers[label].port
                before = clients[label].get("/api/stats")[1]["executables"]
                loads.setdefault((load, label), []).append(
                    run_loadgen(port, load, payload, endpoint))
                if label == "graph":
                    after = clients["graph"].get("/api/stats")[1]["executables"]
                    held.setdefault(load, []).append(after)
                    print(f"graph server, loadgen {load[0]}x{load[1]}: "
                          f"{after['hits'] - before['hits']} of "
                          f"{after['requests'] - before['requests']} runtime "
                          f"requests found their key held")
        for (load, label), runs in loads.items():
            what = ("/api/process built-in 1x1 PNG" if load == silicon_ci.SMALL_LOAD
                    else f"/api/process-all {w}x{h} PNG")
            for run in runs:
                print(f"[{card}] loadgen {what} {load[0]}x{load[1]} {label}: "
                      f"{run['req_per_s']:.1f} req/s, p50 {run['p50_ms']:.1f} ms, "
                      f"p99 {run['p99_ms']:.1f} ms")
    finally:
        for server in servers.values():
            server.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    del staged_rt, first_rt
    full = held[silicon_ci.FULL_LOAD]
    print(f"graph server's executables after loadgen: small "
          f"{json.dumps(held[silicon_ci.SMALL_LOAD][0])}; full, twice "
          f"{json.dumps(full[0])} then {json.dumps(full[1])}")
    for k in ("executables", "pinned_bytes", "device_bytes"):
        require(full[1][k] == full[0][k],
                f"the executables' {k} grew over a repeated load: {full[0][k]} "
                f"-> {full[1][k]}")
    for k in ("process_pinned_bytes", "card_reserved_bytes"):
        require(full[1].get(k, 0) <= full[0].get(k, 0),
                f"{k} grew over a repeated load: {full[0].get(k)} -> "
                f"{full[1].get(k)}")

    # A profiled request traces the graph's replays: `check_launches` holds
    # the trace's hand-kernel launches to LAUNCHES, or the profile raises.
    for f, lv in (("gaussian", 2), ("box", 2), ("sobel", 2), ("gaussian", 1)):
        radius = {"gaussian": MAIN_GAUSS_RADIUS, "box": MAIN_BOX_RADIUS}.get(f)
        through_graph(rt, lambda: calls[f](rt, lv)["image"], f"API {f} L{lv}")
        deep = profile_filter(rt, image, f, lv, MAIN_SIGMA, radius)
        require(rt.executables.values()[-1].captured,
                f"profiled {f} L{lv}: its executable has no graph")
        counts = {short_kernel_name(k): v["count"]
                  for k, v in deep.get("trace_kernel_stats", {}).items()}
        require(rt.device.type != "cuda"
                or deep["duration_source"] == "torch_profiler_trace",
                f"profiled {f} L{lv}: {deep['duration_source']}")
        print(f"[{card}] profiled {f} L{lv} through its graph: check_launches "
              f"passed in {deep['config'].get('Trace Sessions')} session(s), "
              f"{deep['total_kernel_duration_ms']:.4f} ms a call, rows {counts}")
    stats = rt.executables.stats()
    print(f"executables held: {executables_line(rt)}")
    print(f"executable cache: {json.dumps(stats)}; {stats['hits']} of "
          f"{stats['requests']} requests of this runtime found their key held")
    print(f"graph phase: {time.perf_counter() - t7b:.1f} s")


# -- phase 9: the host entry points ------------------------------------------

#: Runs modules in turn as `python -m` would, in one process, and prints
#: one JSON line: each job's exit code, its standard output and the kernel
#: launches made during it (the counts around that job).  One process a
#: batch pays torch's import and the card's context once.
COUNTED_RUN = (
    "import contextlib, io, json, runpy, sys, traceback\n"
    "from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES\n"
    "report = {}\n"
    "for name, module, args in json.loads(sys.argv[1]):\n"
    "    before, out, rc = dict(LAUNCHES), io.StringIO(), 0\n"
    "    sys.argv = [module, *args]\n"
    "    try:\n"
    "        with contextlib.redirect_stdout(out):\n"
    "            runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
    "    except SystemExit as exc:\n"
    "        rc = exc.code if isinstance(exc.code, int) else int(exc.code is not None)\n"
    "    except Exception:\n"
    "        rc = 1\n"
    "        traceback.print_exc()\n"
    "    report[name] = {'rc': rc, 'stdout': out.getvalue(), 'launches': {\n"
    "        k: v - before.get(k, 0) for k, v in LAUNCHES.items()}}\n"
    "print('JOBS ' + json.dumps(report))\n")
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI = "gpu_image_processing_tpu_torch.tools.filter_image"
#: (output, filter, level): every writer, and the rows kernels K1-K4.
CLI_RUNS = [("scene_gaussian.png", "gaussian", 2), ("scene_box.ppm", "box", 2),
            ("scene_sobel.bmp", "sobel", 2), ("scene_band.tga", "gaussian", 4),
            ("scene_gaussian.hdr", "gaussian", 2), ("scene_gaussian.jpg", "gaussian", 2)]
CLI_KERNEL = {("gaussian", 2): "gaussian_rows", ("box", 2): "box_rows",
              ("sobel", 2): "sobel_rows", ("gaussian", 4): "gaussian_band_rows"}
EXAMPLES = ("compose_filters", "profile_kernels", "sharded_batch", "wide_formats")
#: Where phase 10 has the verification tier write its reports (gitignored).
CI_OUT = os.path.join("silicon_out", "chip_smoke")


def gif_bytes(frames: np.ndarray, palette: np.ndarray, delay_cs: int) -> bytes:
    """An animated GIF89a of (N, H, W) palette indices: 8-bit LZW written as
    literal 9-bit codes with a clear code every 254, so the table never
    widens (a valid stream any decoder reads)."""
    _, h, w = frames.shape
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
                    + palette.tobytes())
    for frame in frames:
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08"
        lits = frame.reshape(-1).astype(np.uint16)
        pad = -len(lits) % 254
        groups = np.concatenate([lits, np.zeros(pad, np.uint16)]).reshape(-1, 254)
        codes = np.concatenate([np.full((len(groups), 1), 256, np.uint16), groups],
                               axis=1).reshape(-1)
        codes = np.concatenate([codes[:len(codes) - pad], [257]]).astype(np.uint16)
        bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
        data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
        for i in range(0, len(data), 255):
            out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
        out += b"\x00"
    return bytes(out + b"\x3b")


def png16_bytes(wide: np.ndarray) -> bytes:
    """A 16-bit RGB PNG (filter None rows, zlib level 1)."""
    h, w, c = wide.shape
    lines = np.zeros((h, 1 + w * c * 2), np.uint8)
    lines[:, 1:] = wide.astype(">u2").view(np.uint8).reshape(h, -1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(lines.tobytes(), 1)) + chunk(b"IEND", b""))


def start_counted(jobs: list[tuple[str, str, list[str]]],
                  cwd: str) -> subprocess.Popen:
    """The (name, module, args) jobs in turn in one subprocess, each run as
    `python -m module args` would be, reporting each job's launches."""
    return subprocess.Popen(
        [sys.executable, "-c", COUNTED_RUN, json.dumps(jobs)], cwd=cwd,
        env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_counted(proc: subprocess.Popen, what: str) -> dict[str, tuple[str, dict]]:
    """{job: (stdout, launch counts)} of a counted batch; fails unless the
    batch and every job in it exited 0."""
    out, err = proc.communicate(timeout=600)
    reports = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
               if line.startswith("JOBS ")]
    require(proc.returncode == 0 and len(reports) == 1,
            f"{what}: exit {proc.returncode}\n{out[-2000:]}\n{err[-3000:]}")
    for name, job in reports[0].items():
        require(job["rc"] == 0, f"{name}: exit {job['rc']}\n"
                f"{job['stdout'][-2000:]}\n{err[-3000:]}")
    return {name: (job["stdout"], job["launches"])
            for name, job in reports[0].items()}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def host_entry_points(rt: FilterRuntime, card: str, scene: np.ndarray,
                      scene_png: bytes, rng: np.random.Generator) -> None:
    """Phase 9: the native PNG tier, the image-file CLI, the launcher with
    the API client, and the examples, at full size on the card."""
    t9 = time.perf_counter()
    h, w, c = scene.shape
    pixels = native_codec.png_decode

    def direct(f: str, lv: int, img: np.ndarray = scene) -> np.ndarray:
        if f == "gaussian":
            return api.gaussian_blur(img, MAIN_SIGMA, MAIN_GAUSS_RADIUS, lv,
                                     runtime=rt)["image"]
        if f == "box":
            return api.box_blur(img, MAIN_BOX_RADIUS, lv, runtime=rt)["image"]
        return api.sobel_edge_detection(img, lv, runtime=rt)["image"]

    # 9.1 The native PNG tier against the zlib tier on the scene upload.
    native = pixels(scene_png)
    require(native is not None and np.array_equal(native, decode_png(scene_png))
            and np.array_equal(native, scene),
            "native png_decode of the scene differs from the zlib tier")
    answer = direct("gaussian", 2)
    require(np.array_equal(pixels(encode_png(answer)), answer),
            "png_encode of an answer does not decode back")
    print("native PNG tier: the scene upload decodes to the zlib tier's pixels; "
          "an answer's png_encode decodes back")

    work = tempfile.mkdtemp(prefix="gip_smoke_host_")
    try:
        # 9.2 The CLI on full-size files, its runs in turn in one process,
        # the examples in turn in another beside it.
        with open(os.path.join(work, "scene.png"), "wb") as f:
            f.write(native_codec.png_encode(scene))
        wide = scene.astype(np.uint16) * 257 + rng.integers(0, 257, scene.shape,
                                                            dtype=np.uint16)
        with open(os.path.join(work, "wide.png"), "wb") as f:
            f.write(png16_bytes(wide))
        # Three frames of the scene at a quarter of its sides, in 3-3-2 bit
        # colour, each shifted along the rows.
        small = scene[::4, ::4].astype(np.uint16)
        index = ((small[..., 0] >> 5) << 5) | ((small[..., 1] >> 5) << 2) | (small[..., 2] >> 6)
        i = np.arange(256)
        palette = np.stack([((i >> 5) << 5) + 16, (((i >> 2) & 7) << 5) + 16,
                            ((i & 3) << 6) + 32], axis=1).astype(np.uint8)
        frames = np.stack([np.roll(index, 7 * k, axis=1) for k in range(3)]
                          ).astype(np.uint8)
        with open(os.path.join(work, "anim.gif"), "wb") as f:
            f.write(gif_bytes(frames, palette, 6))
        params = {"gaussian": ["--sigma", str(MAIN_SIGMA), "--radius",
                               str(MAIN_GAUSS_RADIUS)],
                  "box": ["--radius", str(MAIN_BOX_RADIUS)], "sobel": []}
        # The launcher starts (its backend warms its kernels) while the CLI
        # runs and the examples run, one process each.
        ports = (free_port(), free_port())
        run_dir = os.path.join(work, "run")
        launcher = [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools.serve",
                    "--device", "cuda", "--host", "127.0.0.1", "--port",
                    str(ports[0]), "--frontend-port", str(ports[1]),
                    "--run-dir", run_dir, "--timeout", "300"]
        t0 = time.perf_counter()
        starting = subprocess.Popen([*launcher[:3], "start", *launcher[3:]],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
        batches = {}
        try:
            cli_jobs = [(out, CLI, ["scene.png", out, "--filter", f, "--level", str(lv),
                                    *params[f]]) for out, f, lv in CLI_RUNS]
            cli_jobs.append(("wide", CLI, ["wide.png", "wide_out.png", "--load", "16",
                                           "--filter", "gaussian", *params["gaussian"]]))
            cli_jobs.append(("frames", CLI, ["anim.gif", "--frames", "--filter", "box",
                                             *params["box"]]))
            batches = {"CLI": start_counted(cli_jobs, work), "examples": start_counted(
                [(name, f"gpu_image_processing_tpu_torch.examples.{name}", [])
                 for name in EXAMPLES], work)}
            results = {}
            for what, proc in batches.items():
                results.update(finish_counted(proc, what))
            cli_launches, diffs = {}, {}
            for out, f, lv in CLI_RUNS:
                stdout, counts = results[out]
                kernel = CLI_KERNEL[(f, lv)]
                require(counts.get(kernel, 0) > 0,
                        f"CLI {f} L{lv} never launched {kernel}: {counts}")
                cli_launches[out] = {k: v for k, v in counts.items() if v}
                lines = stdout.splitlines()
                require(lines[0] == f"Loaded scene.png: {w}x{h}, {c} channel(s)"
                        and lines[1] == f"Filter: {f} level {lv}"
                        and lines[2].startswith("  Time:") and lines[3].startswith(
                            "  Bandwidth:") and lines[4].startswith("  FPS:")
                        and re.fullmatch(r"  (meets|misses) 30 FPS target \(33\.3 ms budget\)",
                                         lines[5])
                        and re.fullmatch(r"  (meets|misses) 60 FPS target \(16\.7 ms budget\)",
                                         lines[6])
                        and lines[7] == f"Saved: {out}" and len(lines) == 8,
                        f"CLI {f} L{lv} printed:\n{stdout}")
                with open(os.path.join(work, out), "rb") as fh:
                    data = fh.read()
                want = direct(f, lv)
                ext = os.path.splitext(out)[1]
                if ext == ".hdr":
                    ref = os.path.join(work, "ref.hdr")
                    native_codec.hdr_write(ref, want)
                    with open(ref, "rb") as fh:
                        require(data == fh.read(), "CLI .hdr differs from hdr_write")
                    # RGBE shares one exponent among a pixel's channels, so a
                    # dark channel beside a bright one reads back coarser.
                    back = native_codec.hdr_decode(data)
                    diffs["hdr"] = np.abs(back.astype(int) - want)
                    require(back.shape == want.shape and diffs["hdr"].mean() < 2.0,
                            f"CLI .hdr reads back with mean error "
                            f"{diffs['hdr'].mean():.2f}")
                elif ext == ".jpg":
                    require(data == native_codec.jpeg_encode(want, 90),
                            "CLI .jpg differs from jpeg_encode at quality 90")
                    back = native_codec.jpeg_decode(data)
                    diffs["jpg"] = np.abs(back.astype(int) - want)
                    require(back.shape == want.shape and diffs["jpg"].mean() < 3.0,
                            f"CLI .jpg reads back with mean error "
                            f"{diffs['jpg'].mean():.2f}")
                else:
                    back = {".png": pixels, ".ppm": native_codec.pnm_decode,
                            ".bmp": native_codec.bmp_decode,
                            ".tga": native_codec.tga_decode}[ext](data)
                    require(np.array_equal(back, want),
                            f"CLI {f} L{lv} {ext} differs from the API's result")
            stdout, counts = results["wide"]
            wide_want = direct("gaussian", 2, (wide >> 8).astype(np.uint8))
            with open(os.path.join(work, "wide_out.png"), "rb") as fh:
                require(np.array_equal(pixels(fh.read()), wide_want),
                        "CLI --load 16 differs from the API on the high byte")
            require(stdout.splitlines()[0] == (
                f"Loaded wide.png as uint16: range [{int(wide.min())}, "
                f"{int(wide.max())}] (3 channel(s))") and counts.get("gaussian_rows", 0) > 0,
                f"CLI --load 16 printed:\n{stdout}")
            stdout, counts = results["frames"]
            require(stdout.splitlines()[0].startswith(
                f"Loaded anim.gif: 3 frame(s), {w // 4 + (w % 4 > 0)}x{h // 4 + (h % 4 > 0)} "
                f"(native tier), delays(ms)=[60, 60, 60]") and counts.get("box_rows", 0) > 0,
                f"CLI --frames printed:\n{stdout}")
            for k in range(3):
                with open(os.path.join(work, f"anim_box_l2_f{k:03d}.png"), "rb") as fh:
                    require(np.array_equal(pixels(fh.read()), direct(
                        "box", 2, palette[frames[k]])),
                        f"CLI --frames frame {k} differs from the API")
            print(f"CLI at {w}x{h}: {len(CLI_RUNS)} runs (.png .ppm .bmp .tga lossless "
                  f"and equal to the API; .hdr and .jpg the native writers' bytes, "
                  f"read back within mean / max " + ", ".join(
                      f"{k} {d.mean():.3f} / {d.max()}" for k, d in diffs.items())
                  + "), "
                  f"--load 16, --frames on 3 GIF frames; launches a run: "
                  + "; ".join(f"{o} {n}" for o, n in cli_launches.items()))
            print(f"examples: {', '.join(EXAMPLES)} exit 0 on cuda; "
                  + "; ".join(f"{n}: {results[n][0].strip().splitlines()[-1]}"
                              for n in EXAMPLES))

            # 9.3 The launcher on free ports, the client through it, one
            # full-size process-all, then stop: nothing of it left.
            start_out, start_err = starting.communicate(timeout=400)
            start_s = time.perf_counter() - t0
            pids = [serve.read_pid(run_dir, n) for n in ("backend", "frontend")]
            require(starting.returncode == 0 and all(pids),
                    f"serve start: exit {starting.returncode}\n{start_out}"
                    f"\n{start_err}")
            opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
            with opener.open(f"http://127.0.0.1:{ports[1]}/", timeout=30) as resp:
                require(resp.read() == open(os.path.join(ROOT, "frontend", "index.html"),
                                            "rb").read(),
                        "the frontend's / is not frontend/index.html")
            base = f"http://127.0.0.1:{ports[0]}"
            checked = subprocess.run(
                [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools.client",
                 "--base", base, "--outdir", os.path.join(work, "client")],
                capture_output=True, text=True, timeout=600)
            require(checked.returncode == 0 and checked.stdout.count("[PASS]") == 10
                    and "[FAIL]" not in checked.stdout,
                    f"client: exit {checked.returncode}\n{checked.stdout}\n"
                    f"{checked.stderr[-2000:]}")
            client = Client(base, card)
            tiers0 = client.get("/api/stats")[1]["decode_tiers"]
            scene_b64 = "data:image/png;base64," + base64.b64encode(scene_png).decode()
            status, out = client.post("/api/process-all", {
                "image": scene_b64, "filter": "gaussian", "sigma": MAIN_SIGMA,
                "radius": MAIN_GAUSS_RADIUS}, f"gaussian {w}x{h} through the launcher")
            require(status == 200, f"process-all through the launcher: {status}")
            tiers = client.get("/api/stats")[1]["decode_tiers"]
            require(tiers["native_png"] - tiers0["native_png"] == 1
                    and tiers0["native_png"] == 6 and tiers["zlib_png"] == 0,
                    f"decode_tiers after the client's 6 PNG uploads and one "
                    f"process-all: {tiers0} -> {tiers}")
            require(out["original_image"] == scene_b64,
                    "process-all: the original is not the upload passed through")
            for lv in (1, 2):
                require(np.array_equal(pixels(base64.b64decode(
                    out["results"][f"level_{lv}"]["processed_image"].split(",", 1)[1])),
                    direct("gaussian", lv)),
                    f"process-all through the launcher: level_{lv} differs")
        finally:
            for proc in (starting, *batches.values()):
                if proc.poll() is None:   # a check failed before its end
                    proc.kill()
                    proc.communicate()
            stopped = subprocess.run([*launcher[:3], "stop", *launcher[3:]],
                                     capture_output=True, text=True, timeout=120)
        for pid in filter(None, pids):
            try:   # reap it if this process inherited it
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
        alive = [pid for pid in filter(None, pids) if serve.pid_alive(pid)]
        require(stopped.returncode == 0 and not alive
                and not serve.port_in_use(ports[0]) and not serve.port_in_use(ports[1]),
                f"serve stop: exit {stopped.returncode}, alive {alive}\n{stopped.stdout}")
        print(f"launcher: start on cuda in {start_s:.1f} s (backend pid {pids[0]}, "
              f"frontend pid {pids[1]} serving frontend/index.html), the client's "
              f"10 checks PASS, process-all {w}x{h} answers decode to the API's "
              f"pixels, decode_tiers.native_png counted all 7 PNG uploads; stop: "
              f"no process left, ports {ports[0]} and {ports[1]} free")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"host entry points phase: {time.perf_counter() - t9:.1f} s")


def verification_tier(card: str) -> None:
    """Phase 10: `tools/silicon_ci.py`, every stage, in one subprocess."""
    t10 = time.perf_counter()
    out_dir = os.path.join(ROOT, CI_OUT)
    shutil.rmtree(out_dir, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools.silicon_ci",
         "--device", "cuda", "--out-dir", out_dir], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    try:
        with open(os.path.join(out_dir, "silicon_ci.json")) as f:
            stages = json.load(f)["stages"]
    except (OSError, ValueError):
        stages = {}
    require(set(stages) == {"validate", "soak", "sol", "serving"},
            f"silicon_ci: exit {proc.returncode}, stages {sorted(stages)}\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    print("verification stages (s): " + ", ".join(
        f"{name} {st['seconds']:.1f} {'PASS' if st['ok'] else 'FAIL'}"
        for name, st in stages.items()))
    validation, soak = stages["validate"]["details"], stages["soak"]["details"]
    print(f"validation: {len(validation.get('checks', []))} checks, TOTAL "
          f"FAILURES: {validation.get('failures')}; soak: N = {soak.get('trials')}, "
          + ", ".join(f"section {s['section']} {s['trials']} trials"
                      for s in soak.get("sections", []))
          + f", SOAK DONE: {soak.get('failures')} failures")
    for sec in soak.get("sections", []):
        print(f"soak section {sec['section']}: executables after it "
              f"{json.dumps(sec.get('executables'))}")
    sol = stages["sol"]["details"]
    for row in sol.get("rows", []):
        for op in row["ops"]:
            if op["kernel"]:
                print(f"[{card}] sol {row['filter']} L{row['level']} "
                      f"{op['kernel']}: {op['avg_ms']:.4f} ms x{op['launches']}, "
                      f"{op['share_pct']:.1f}% of the call, "
                      + (f"{op['pct_of_bound']:.1f}% of bound ({op['bound']}-bound; "
                         f"bytes {op['sol_pct']:.1f}%, {op['ops_rate']} operations "
                         f"{op['sol_pct_ops']:.1f}%)" if op.get("pct_of_bound")
                         is not None else f"no % of bound ({op.get('sol_note')})"))
    if sol.get("problems"):
        print("sol problems: " + "; ".join(sol["problems"]))
    serving = stages["serving"]
    print("serving: " + serving["tail"].replace("\n", "\n  "))
    for name, st in stages.items():
        print(f"phase 10 {name} launches: {json.dumps(st['details'].get('launches'))}")
    print(f"phase 10 serving: executables held before and after each loadgen "
          f"run: {json.dumps(serving['details'].get('executables'))}")
    failed = [name for name, st in stages.items() if not st["ok"]]
    require(proc.returncode == 0 and not failed,
            f"silicon_ci: exit {proc.returncode}, failed stages {failed}:\n"
            + "\n".join(f"{n}: {stages[n]['tail']}" for n in failed))
    print(f"verification phase: {time.perf_counter() - t10:.1f} s")


# -- phase 11: the installed package ------------------------------------------

#: What the wheel is built from: the two packages, the packaging files and
#: the native sources it carries (setup.py).
WHEEL_INPUTS = ("gpu_image_processing_tpu", "gpu_image_processing_tpu_torch",
                "pyproject.toml", "setup.py", *files.CARRIED)
#: Where the installed package finds what it builds from, and where it
#: builds, as the install reports them.
INSTALLED_PROBE = (
    "import json, gpu_image_processing_tpu_torch as pkg\n"
    "from gpu_image_processing_tpu_torch.core import files\n"
    "from gpu_image_processing_tpu_torch.ops.cuda import build\n"
    "print(json.dumps({'package': pkg.__file__, 'build_dir': str(build.BUILD_DIR),"
    " 'carried': [str(files.repo_file(p)) for p in files.CARRIED]}))\n")


def tree_files(root: str) -> dict[str, tuple[int, int]]:
    """Each file under `root`: (size, modification time in ns)."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            st = os.stat(os.path.join(dirpath, name))
            out[os.path.join(dirpath, name)] = (st.st_size, st.st_mtime_ns)
    return out


def installed_package(card: str, scene_jpeg: bytes,
                      jpeg_answer: dict[int, str]) -> None:
    """Phase 11: the port built into a wheel, installed read-only and run
    from a directory outside the checkout on the card: the image-file CLI
    and the launcher with one /api/process-all, against the checkout's
    answers byte for byte; no nvcc, nothing written under the install."""
    t11 = time.perf_counter()
    steps: dict[str, float] = {}
    base = tempfile.mkdtemp(prefix="gip_smoke_wheel_")
    src, dist, target, work, cache, fake_bin = (
        os.path.join(base, d) for d in ("src", "dist", "install", "work",
                                        "cache", "bin"))
    try:
        # 11.1 The wheel, from a copy of its inputs (a copy of the repository
        # without .git has no `git archive`), offline; its install, made
        # read-only.
        t = time.perf_counter()
        for name in WHEEL_INPUTS:
            if os.path.isdir(name):
                shutil.copytree(name, os.path.join(src, name), ignore=(
                    shutil.ignore_patterns("_build", "__pycache__")))
            else:
                os.makedirs(os.path.dirname(os.path.join(src, name)),
                            exist_ok=True)
                shutil.copy(name, os.path.join(src, name))
        for what, cmd in (
                ("wheel", ["wheel", "--no-deps", "--no-build-isolation",
                           "--no-index", "-w", dist, src]),
                ("install", ["install", "--no-deps", "--no-index", "--target",
                             target])):
            if what == "install":
                cmd.append(os.path.join(dist, os.listdir(dist)[0]))
            proc = subprocess.run([sys.executable, "-m", "pip", *cmd],
                                  capture_output=True, text=True, timeout=300)
            require(proc.returncode == 0, f"pip {what}: exit {proc.returncode}\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            steps[what] = time.perf_counter() - t
            t = time.perf_counter()
        subprocess.run(["chmod", "-R", "a-w", target], check=True)
        installed = tree_files(target)
        # 11.2 The cache holds the checkout's kernel libraries and nothing
        # else; an nvcc first on PATH leaves a mark and fails.
        cache_dir = os.path.join(cache, "gpu_image_processing_tpu_torch")
        os.makedirs(cache_dir)
        for name in build.SOURCES:
            shutil.copy(build._built(name), cache_dir)
        mark = os.path.join(base, "nvcc_ran")
        os.makedirs(fake_bin)
        with open(os.path.join(fake_bin, "nvcc"), "w") as f:
            f.write(f'#!/bin/sh\necho "$0 $*" >> {mark}\nexit 1\n')
        os.chmod(os.path.join(fake_bin, "nvcc"), 0o755)
        os.makedirs(work)
        env = {**os.environ, "PYTHONPATH": target, "XDG_CACHE_HOME": cache,
               "PATH": fake_bin + os.pathsep + os.environ.get("PATH", "")}
        jpeg = os.path.join(work, "scene.jpg")
        with open(jpeg, "wb") as f:
            f.write(scene_jpeg)
        port, refused_port = free_port(), free_port()
        serve_cli = [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools.serve"]
        serve_opts = ["--device", "cuda", "--host", "127.0.0.1", "--port",
                      str(port), "--run-dir", os.path.join(work, "run"),
                      "--timeout", "300"]
        cli = [sys.executable, "-m", CLI, jpeg]
        cli_opts = ["--filter", "gaussian", "--level", "2", "--sigma",
                    str(MAIN_SIGMA), "--radius", str(MAIN_GAUSS_RADIUS),
                    "--device", "cuda"]
        # 11.3 Side by side: the installed CLI, the checkout's, the
        # installed launcher's start, a start that must refuse, and the
        # install's own account of its sources.
        jobs = {
            "cli": ([*cli, os.path.join(work, "installed.png"), *cli_opts], work, env),
            "cli (checkout)": ([*cli, os.path.join(work, "checkout.png"), *cli_opts],
                               ROOT, {**os.environ, "PYTHONPATH": ROOT}),
            "start": ([*serve_cli, "start", "--no-frontend", *serve_opts], work, env),
            "start with frontend": ([*serve_cli, "start", "--device", "cuda",
                                     "--port", str(refused_port), "--run-dir",
                                     os.path.join(work, "refused")], work, env),
            "sources": ([sys.executable, "-c", INSTALLED_PROBE], work, env),
        }
        t = time.perf_counter()
        procs = {name: subprocess.Popen(cmd, cwd=cwd, env=job_env,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                 for name, (cmd, cwd, job_env) in jobs.items()}

        def finish(name: str) -> tuple[str, tuple[int, str, str]]:
            out, err = procs[name].communicate(timeout=300)
            steps[name] = time.perf_counter() - t
            return name, (procs[name].returncode, out, err)

        with ThreadPoolExecutor(len(procs)) as pool:
            outputs = dict(pool.map(finish, procs))
        failed = {n: o for n, o in outputs.items()
                  if (o[0] != 0) != (n == "start with frontend")}
        require(not failed, "installed package: " + "; ".join(
            f"{n} exit {rc}\n{out[-1500:]}\n{err[-1500:]}"
            for n, (rc, out, err) in failed.items()))
        refusal = outputs["start with frontend"][2]
        require("frontend/" in refusal and "--no-frontend" in refusal
                and "Backend starting" not in outputs["start with frontend"][1],
                f"start without --no-frontend did not refuse by name: {refusal}")
        sources = json.loads(outputs["sources"][1])
        require(sources["package"].startswith(target + os.sep)
                and sources["build_dir"] == cache_dir
                and all(p.startswith(os.path.join(target, "gpu_image_processing_tpu_torch",
                                                  "_carried") + os.sep)
                        for p in sources["carried"]),
                f"the install builds from elsewhere: {sources}")
        with open(os.path.join(work, "installed.png"), "rb") as f:
            ours = f.read()
        with open(os.path.join(work, "checkout.png"), "rb") as f:
            theirs = f.read()
        require(ours == theirs, f"the installed CLI wrote {len(ours)} bytes, not "
                f"the checkout's {len(theirs)}")
        # 11.4 One /api/process-all of the JPEG on the installed server,
        # against the checkout server's answer (phase 5), then stop.
        client = Client(f"http://127.0.0.1:{port}", card)
        t = time.perf_counter()
        try:
            status, out = client.post(
                "/api/process-all", {"image": "data:image/jpeg;base64,"
                                     + base64.b64encode(scene_jpeg).decode(),
                                     "filter": "gaussian", "sigma": MAIN_SIGMA,
                                     "radius": MAIN_GAUSS_RADIUS},
                "gaussian JPEG, the installed server")
            steps["process-all"] = time.perf_counter() - t
            require(status == 200, f"installed process-all: {status} {str(out)[:300]}")
            for lv in (1, 2):
                require(out["results"][f"level_{lv}"]["processed_image"]
                        == jpeg_answer[lv],
                        f"installed process-all level_{lv} differs from the "
                        f"checkout server's answer")
            launches = client.get("/api/stats")[1]["kernel_launches"]
            require(launches.get("gaussian_rows", 0) > 0,
                    f"the installed server launched no gaussian_rows: {launches}")
        finally:
            # In this process: its PID file names the installed backend.
            t = time.perf_counter()
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                stopped = serve.main(["stop", *serve_opts])
            steps["stop"] = time.perf_counter() - t
        require(stopped == 0
                and serve.read_pid(os.path.join(work, "run"), serve.BACKEND) is None
                and not serve.port_in_use(port),
                f"installed stop: {said.getvalue()}")
        # 11.5 No nvcc ran; the cache gained the codec's library, compiled
        # from the install's copies under the checkout's name; nothing was
        # written under the install.
        require(not os.path.exists(mark), "phase 11 ran nvcc: "
                + (open(mark).read() if os.path.exists(mark) else ""))
        want = {build._built(name).name for name in build.LIBRARIES}
        require(set(os.listdir(cache_dir)) == want,
                f"the cache holds {sorted(os.listdir(cache_dir))}, not {sorted(want)}")
        require(tree_files(target) == installed,
                "phase 11 wrote under the install")
    finally:
        subprocess.run(["chmod", "-R", "u+w", base], check=False)
        shutil.rmtree(base, ignore_errors=True)
    print(f"[{card}] installed package: wheel {steps['wheel']:.1f} s, install "
          f"{steps['install']:.1f} s, then side by side (s from their start): "
          + ", ".join(f"{n} {steps[n]:.1f}" for n in jobs)
          + f"; process-all {steps['process-all']:.1f} s, stop {steps['stop']:.1f} s; "
          f"no nvcc, the CLI's PNG and the served levels byte-equal to the "
          f"checkout's, nothing written under the install")
    print(f"installed package phase: {time.perf_counter() - t11:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # -- 1. device ----------------------------------------------------------
    card_info = describe(dev)
    cap = card_info["capability"]
    require(cap == (9, 0), f"needs compute capability 9.0, found {cap}")
    card = card_info["name_power_limit"]
    print(card)
    nvcc_version = next(
        line for line in subprocess.run(
            [build.nvcc_path(), "--version"], capture_output=True, text=True,
            check=True).stdout.splitlines() if "release" in line)
    print(f"device: {card_info['name']}, capability {cap}, "
          f"count {torch.cuda.device_count()}")
    print(f"toolchain: torch {card_info['torch']}, torch CUDA "
          f"{card_info['cuda']}, nvcc {nvcc_version}")
    print("build route: nvcc -shared -Xcompiler -fPIC, extern \"C\" launch "
          "functions loaded with ctypes")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    # With the load generator of phase 10's serving stage beside them.
    build.build_all((*build.LIBRARIES, build.LOADGEN))
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(build.LIBRARIES)} and {build.LOADGEN} (one compiler "
          f"each, in parallel: nvcc for the kernels, the host C++ compiler "
          f"for the codec's library and loadgen); each: " + ", ".join(
              f"{n} {t:.1f} s" for n, t in build.BUILD_SECONDS.items()))
    cxx_version = subprocess.run([build.cxx_path(), "--version"], capture_output=True,
                                 text=True, check=True).stdout.splitlines()[0]
    codec_sources = [p for p in files.CARRIED if p.endswith(".cpp")]
    require("native/src/gip_codec.cpp" in codec_sources,
            f"the codec's library is built from {codec_sources}")
    print(f"codec library ({build.DECODERS}): built from "
          f"{', '.join(codec_sources)} with {' '.join(build.CXX_LIBS)} by "
          f"{cxx_version} in {build.BUILD_SECONDS.get(build.DECODERS, 0.0):.1f} s")
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernel vs plain -------------------------------------------------
    max_err = {name: 0 for name in KERNELS}
    band_differing = [0, 0]   # bytes that differ, bytes compared

    def compare(name, got, want, what):
        diff = absdiff(got, want)
        d, frac = int(diff.max()), float((diff > 0).float().mean())
        max_err[name] = max(max_err[name], d)
        colour_sobel = (name in ("sobel_rows", "sobel_planar")
                        and what.endswith(("x3", "x4")))
        if colour_sobel:
            require(d <= SOBEL_MAX_DIFF and frac <= SOBEL_MAX_FRACTION,
                    f"{name} {what}: maxdiff {d}, fraction {frac}")
        elif name == "gaussian_band_rows":
            band_differing[0] += int((diff > 0).sum())
            band_differing[1] += diff.numel()
            require(d <= blur.BAND_MAX_DIFF and frac <= blur.BAND_MAX_FRACTION,
                    f"{name} {what}: maxdiff {d}, fraction {frac}")
        else:
            require(d == 0, f"{name} {what}: maxdiff {d}")
        return d

    for h, w, c in SHAPES:
        img = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        rows = torch.from_numpy(img.reshape(h, w * c)).to(dev)
        shape = f"{h}x{w}x{c}"
        diffs = {}
        for (radius, sigma), box_radius in zip(GAUSS, BOX_RADII):
            for name, (kernel, plain) in launchers(
                    dev, radius, sigma, box_radius, w, c).items():
                if name.startswith("sobel") and radius != GAUSS[0][0]:
                    continue
                r = box_radius if name == "box_rows" else radius
                diffs[(name, r)] = compare(name, kernel(rows), plain(rows), shape)
        for r in BOX_WIDE_RADII:
            diffs[("box_rows", r)] = compare(
                "box_rows", blur.box_rows(rows, r, c), blur.box_rows_plain(rows, r, c),
                shape)
        r, sigma = GAUSS_RUNTIME_RADIUS
        for name, (kernel, plain) in launchers(dev, r, sigma, MAIN_BOX_RADIUS,
                                               w, c).items():
            if name in ("gaussian_rows", "gaussian_folded_rows"):
                diffs[(name, r)] = compare(name, kernel(rows), plain(rows), shape)
        print(f"compare {shape}: " + ", ".join(
            f"{n} r={r} {d}" for (n, r), d in diffs.items()))
    torch.cuda.synchronize()
    # The band is deterministic: a second launch gives the same bits.
    for radius, sigma in GAUSS[2:]:
        band_k, _ = launchers(dev, radius, sigma, MAIN_BOX_RADIUS, w, c)["gaussian_band_rows"]
        require(torch.equal(band_k(rows), band_k(rows)),
                f"gaussian_band_rows r={radius}: two launches differ")
    print(f"gaussian_band_rows vs plain: {band_differing[0]} of {band_differing[1]} "
          f"bytes differ, maxdiff {max_err['gaussian_band_rows']}; a second launch "
          f"at {h}x{w}x{c} r=3, 15, 31 gives the same bits")

    # Threads that launch the rows gaussian at once, as the threaded
    # server's requests do: each launch carries its own taps.
    h, w, c = SHAPES[0]
    rows = torch.from_numpy(rng.integers(0, 256, size=(h, w * c), dtype=np.uint8)).to(dev)
    thread_cases = [(MAIN_GAUSS_RADIUS, 1.0), (MAIN_GAUSS_RADIUS, MAIN_SIGMA),
                    GAUSS_RUNTIME_RADIUS]
    thread_outs = {case: [] for case in thread_cases}

    def launch_many(radius, sigma):
        kernel, _ = launchers(dev, radius, sigma, MAIN_BOX_RADIUS, w, c)["gaussian_rows"]
        for _ in range(100):
            thread_outs[(radius, sigma)].append(kernel(rows))

    threads = [threading.Thread(target=launch_many, args=case) for case in thread_cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for (radius, sigma), outs in thread_outs.items():
        _, plain = launchers(dev, radius, sigma, MAIN_BOX_RADIUS, w, c)["gaussian_rows"]
        want = plain(rows)
        require(len(outs) == 100 and all(torch.equal(o, want) for o in outs),
                f"gaussian_rows from threads r={radius} sigma={sigma}: differs")
    print(f"gaussian_rows from {len(threads)} threads at once, 100 launches each "
          f"(r, sigma) = {thread_cases}: every launch equals its plain version")
    del thread_outs

    # The planar kernels on the same shapes, as (C, H, W) planes.
    for h, w, c in SHAPES:
        img = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        planes = planar_api.to_planes(torch.from_numpy(img).to(dev))
        shape = f"{h}x{w}x{c}"
        diffs = {}
        for (radius, sigma), box_radius in zip(GAUSS, PLANAR_BOX_RADII):
            for name, (kernel, plain) in planar_launchers(
                    dev, radius, sigma, box_radius).items():
                if name.startswith("sobel") and radius != GAUSS[0][0]:
                    continue
                r = box_radius if name == "box_planar" else radius
                diffs[(name, r)] = compare(name, kernel(planes), plain(planes), shape)
        print(f"compare planar {shape}: " + ", ".join(
            f"{n} r={r} {d}" for (n, r), d in diffs.items()))
    torch.cuda.synchronize()

    # Batches at the server's radii (gaussian sigma 2 r=3 at level 2 and in
    # the band, folded at r=2, box r=5): one launch over (B, H, W*C) equals
    # the plain version on the same batch and B single-image launches.
    batch_cases = [(h, w, c, 3) for h, w, c in SHAPES[:-1]] + [(*FULL, 4)]
    for h, w, c, b in batch_cases:
        imgs = rng.integers(0, 256, size=(b, h, w * c), dtype=np.uint8)
        rows = torch.from_numpy(imgs).to(dev)
        shape = f"{b}x{h}x{w}x{c}"
        pairs = launchers(dev, MAIN_GAUSS_RADIUS, MAIN_SIGMA, MAIN_BOX_RADIUS, w, c)
        pairs["gaussian_folded_rows"] = launchers(
            dev, FOLDED_RADIUS, 1.5, MAIN_BOX_RADIUS, w, c)["gaussian_folded_rows"]
        diffs = {}
        for name, (kernel, plain) in pairs.items():
            out = kernel(rows)
            diffs[name] = compare(name, out, plain(rows), shape)
            for i in range(b):
                require(torch.equal(out[i], kernel(rows[i].contiguous())),
                        f"{name} batch {shape}: image {i} differs from its "
                        f"single launch")
        print(f"batch {shape}: kernel vs plain maxdiff " + ", ".join(
            f"{n} {d}" for n, d in diffs.items())
            + "; every image equals its single launch")
    torch.cuda.synchronize()

    # The planar kernels on a batch: 4 full-size images (83 MB), K5 on their
    # 12 planes and K7 on (4, 3, H, W), one launch each, against the plain
    # version on the same planes and against single-image launches; the
    # tier's batch functions, which run the rows kernels on the (B, H, W*C)
    # view, equal the planar kernels' result.
    h, w, c = FULL
    b = 4
    imgs = torch.from_numpy(rng.integers(0, 256, size=(b, *FULL), dtype=np.uint8)).to(dev)
    batch_planes = imgs.permute(0, 3, 1, 2).contiguous()      # (B, C, H, W)
    flat = batch_planes.view(b * c, h, w)
    w3 = weights_to_torch(gaussian_kernel_f32(MAIN_GAUSS_RADIUS, MAIN_SIGMA), dev)
    w2 = weights_to_torch(gaussian_kernel_f32(FOLDED_RADIUS, 1.5), dev)
    w3_host, w2_host = w3.cpu(), w2.cpu()
    r3, r2, br = MAIN_GAUSS_RADIUS, FOLDED_RADIUS, MAIN_BOX_RADIUS
    batch_cases = {   # (kernel, plain, the tier's batch function)
        "gaussian_planar": (
            lambda x: blur_planar.gaussian_planar(x, w3_host, r3),
            lambda x: blur_planar.gaussian_planar_plain(x, w3, r3),
            lambda: planar_api.gaussian_planar_batch(imgs, w3_host, r3)),
        "gaussian_folded_planar": (
            lambda x: blur_planar.gaussian_folded_planar(x, w2_host, r2),
            lambda x: blur_planar.gaussian_folded_planar_plain(x, w2, r2),
            lambda: planar_api.gaussian_planar_batch(imgs, w2_host, r2, folded=True)),
        "box_planar": (
            lambda x: blur_planar.box_planar(x, br),
            lambda x: blur_planar.box_planar_plain(x, br),
            lambda: planar_api.box_planar_batch(imgs, br)),
        "sobel_planar": (
            sobel_planar.sobel_planar,
            lambda x: sobel_planar.sobel_planar_plain(x, 2),
            lambda: planar_api.sobel_planar_batch(imgs, 2)),
        "sobel_f32_planar": (
            sobel_planar.sobel_f32_planar,
            lambda x: sobel_planar.sobel_planar_plain(x, 1),
            lambda: planar_api.sobel_planar_batch(imgs, 1)),
    }
    diffs = {}
    for name, (kernel, plain, tier) in batch_cases.items():
        x = batch_planes if name.startswith("sobel") else flat
        out = kernel(x)
        diffs[name] = compare(name, out, plain(x), f"batch {b}x{h}x{w}x{c}")
        out = out.view(b, c, h, w)
        for i in range(b):
            require(torch.equal(out[i], kernel(batch_planes[i])),
                    f"{name} batch: image {i} differs from its single launch")
        require(torch.equal(tier(), out.permute(0, 2, 3, 1)),
                f"{name} batch: the tier's rows kernels differ from the planar kernel")
    print(f"planar batch {b}x{h}x{w}x{c}: kernel vs plain maxdiff " + ", ".join(
        f"{n} {d}" for n, d in diffs.items()) + "; every image equals its single "
        "launch; the tier's batches (rows kernels) equal the planar kernels")

    # Band modes: rows [BAND_ROWS) of a full-size image, given with their
    # neighbour rows as halo, equal the same rows of the whole image.
    planes = planar_api.to_planes(imgs[0])
    a, z = BAND_ROWS
    for radius, sigma in ((MAIN_GAUSS_RADIUS, MAIN_SIGMA), (31, 8.0)):
        wt = weights_to_torch(gaussian_kernel_f32(radius, sigma), dev)
        band = planes[:, a - radius:z + radius].contiguous()
        for name, fn, plain in (
                ("gaussian_planar",
                 lambda x, **k: blur_planar.gaussian_planar(x, wt, radius, **k),
                 lambda x: blur_planar.gaussian_planar_plain(x, wt, radius, True)),
                ("gaussian_folded_planar",
                 lambda x, **k: blur_planar.gaussian_folded_planar(x, wt, radius, **k),
                 lambda x: blur_planar.gaussian_folded_planar_plain(x, wt, radius, True)),
                ("box_planar",
                 lambda x, **k: blur_planar.box_planar(x, radius, **k),
                 lambda x: blur_planar.box_planar_plain(x, radius, True))):
            got = fn(band, rows_prepadded=True)
            compare(name, got, plain(band), f"band r={radius}")
            require(torch.equal(got, fn(planes)[:, a:z]),
                    f"{name} band r={radius}: differs from the whole image's rows")
    band = planes[None, :, a - 1:z + 1].contiguous()
    for name, fn, level in (("sobel_planar", sobel_planar.sobel_planar, 2),
                            ("sobel_f32_planar", sobel_planar.sobel_f32_planar, 1)):
        got = fn(band, rows_prepadded=True, zero_rows=False)
        compare(name, got, sobel_planar.sobel_planar_plain(band, level, True, False),
                f"band {z - a}x{w}x{c}")
        require(torch.equal(got[0], fn(planes)[:, a:z]),
                f"{name} band: differs from the whole image's rows")
        # No halo rows and the rows kept: the rows outside read grey 0.
        got = fn(planes, zero_rows=False)
        compare(name, got, sobel_planar.sobel_planar_plain(planes, level, False, False),
                f"zero_rows=False {h}x{w}x{c}")
        require(torch.equal(got[:, 1:-1], fn(planes)[:, 1:-1]),
                f"{name} zero_rows=False: inner rows differ")
    torch.cuda.synchronize()
    print(f"planar band rows {a}-{z} of {h}x{w}x{c} with halo rows: gaussian, folded "
          f"and box at r=3 and 31, Sobel (zero_rows=False) at both levels equal "
          f"the whole image's rows and their plain versions; Sobel with "
          f"zero_rows=False and no halo rows equals its plain version")
    del imgs, batch_planes, flat, band

    # The zlib tier (the upload endpoint's and the CLI's PNG reader) through
    # gip_png_decode16 against its plain path (_png_samples and
    # unfilter_plain) on small PNGs whose rows take the five filter types
    # in turn, every colour type at every depth, palettes with tRNS.
    tier_rng = np.random.default_rng(SEED + 1)
    tier_cases = 0
    for colour, depths in sorted(codec.DEPTHS.items()):
        for depth in depths:
            values = tier_rng.integers(0, 1 << depth, (23, 37, codec.SAMPLES[colour]))
            extra = []
            if colour == 3:
                entries = 1 << depth
                extra = [(b"PLTE", tier_rng.integers(0, 256, 3 * entries,
                                                     dtype=np.uint8).tobytes()),
                         (b"tRNS", bytes(range(0, 256, 5))[:max(1, entries // 2)])]
            data = cycled_png(values, depth, colour, extra)
            require(native_codec.png_decode16(data) is not None,
                    f"gip_png_decode16 refused colour type {colour} at depth {depth}")
            plain16 = codec._png_plain16(codec._png_chunks(data))
            require(np.array_equal(codec.decode_png16(data), plain16),
                    f"zlib tier through gip_png_decode16 differs from its plain "
                    f"path: colour type {colour}, depth {depth}")
            require(np.array_equal(native_codec.png_decode(data),
                                   (plain16 >> 8).astype(np.uint8)),
                    f"gip_png_decode is not the high bytes of the plain path: "
                    f"colour type {colour}, depth {depth}")
            tier_cases += 1
    print(f"zlib PNG tier: through gip_png_decode16 == its plain path, "
          f"gip_png_decode == its high bytes, on {tier_cases} PNGs (every "
          f"colour type and depth, filter types 0-4)")
    # The draws an earlier check of this phase took from `rng`: taking them
    # keeps every later input (the API's images, the scene, the batch) the
    # bytes that earlier runs of this script used, so that their codec and
    # request times, and the answer's PNG bytes, compare on the same data.
    for bpp in range(1, 9):
        rng.integers(0, 256, size=(40, 97 * bpp + 1), dtype=np.uint8)
    rng.integers(0, 256, size=(7, 33 * 3), dtype=np.uint8)

    # The upload decoders (PNG, JPEG and the native formats through the
    # codec's library of native/src) on the committed fixtures, against the
    # pixels the JAX package decoded from them (its native tier for JPEG):
    # any difference fails.
    expected = np.load(f"{FORMAT_FIXTURES}/expected.npz")
    fixture_diffs = {}
    for name in sorted(expected.files):
        with open(f"{FORMAT_FIXTURES}/{name}", "rb") as f:
            data = f.read()
        got = decode_base64_image("data:;base64," + base64.b64encode(data).decode())
        require(got.shape == expected[name].shape,
                f"fixture {name}: shape {got.shape}, expected {expected[name].shape}")
        fixture_diffs[name] = int(np.abs(got.astype(int) - expected[name]).max())
        require(fixture_diffs[name] == 0, f"fixture {name}: maxdiff {fixture_diffs[name]}")
    print(f"decoders vs the JAX package on {len(fixture_diffs)} fixtures: maxdiff "
          + ", ".join(f"{n} {d}" for n, d in fixture_diffs.items()))

    rt = FilterRuntime(dev)
    small = rng.integers(0, 256, size=(24, 31, 3), dtype=np.uint8)
    got = api.gaussian_blur(small, MAIN_SIGMA, MAIN_GAUSS_RADIUS, 2, runtime=rt)
    want = oracle.gaussian_blur(
        small, gaussian_kernel_f32(MAIN_GAUSS_RADIUS, MAIN_SIGMA), MAIN_GAUSS_RADIUS)
    require(np.array_equal(got["image"], want), "gaussian L2 != numpy oracle")
    got = api.box_blur(small, MAIN_BOX_RADIUS, 2, runtime=rt)
    require(np.array_equal(got["image"], oracle.box_blur(small, MAIN_BOX_RADIUS)),
            "box L2 != numpy oracle")
    got = api.sobel_edge_detection(small, 2, runtime=rt)
    sd = np.abs(got["image"].astype(int) - oracle.sobel(small, 2))
    require(sd.max() <= SOBEL_MAX_DIFF and (sd > 0).mean() <= SOBEL_MAX_FRACTION,
            f"sobel L2 vs numpy oracle: maxdiff {sd.max()}")
    print(f"oracle 24x31x3 level 2: gaussian exact, box exact, sobel maxdiff {sd.max()}")

    # -- 4. API path at full size -------------------------------------------
    h, w, c = FULL
    image = rng.integers(0, 256, size=FULL, dtype=np.uint8)
    calls = {
        "gaussian": lambda lv: api.gaussian_blur(
            image, MAIN_SIGMA, MAIN_GAUSS_RADIUS, lv, runtime=rt),
        "box": lambda lv: api.box_blur(image, MAIN_BOX_RADIUS, lv, runtime=rt),
        "sobel": lambda lv: api.sobel_edge_detection(image, lv, runtime=rt),
    }
    radius_of = {"gaussian": MAIN_GAUSS_RADIUS, "box": MAIN_BOX_RADIUS, "sobel": 3}

    torch.cuda.synchronize()
    LAUNCHES.clear()
    results = {(f, lv): calls[f](lv) for f in calls for lv in (1, 2)}
    all_levels = {f: rt.run_all_levels(f, image, sigma=MAIN_SIGMA,
                                       radius=radius_of[f]) for f in calls}
    torch.cuda.synchronize()
    api_launches = {name: LAUNCHES[name] for name in API_KERNELS}
    print(f"API path launches: {api_launches}")
    for name, n in api_launches.items():
        require(n > 0, f"API path never launched {name}")

    for (f, lv), res in results.items():
        require(set(res) == {"image", "time_ms", "bandwidth_gbps", "fps"},
                f"{f} L{lv}: result keys {sorted(res)}")
        require(res["image"].shape == FULL and res["image"].dtype == np.uint8,
                f"{f} L{lv}: image {res['image'].shape} {res['image'].dtype}")
        require(all(res[k] > 0 and np.isfinite(res[k])
                    for k in ("time_ms", "bandwidth_gbps", "fps")),
                f"{f} L{lv}: metrics {res}")
        out, metrics = all_levels[f][lv]
        require(np.array_equal(out, res["image"]),
                f"{f} L{lv}: run_all_levels differs from the API call")
        require(metrics.time_ms > 0, f"{f} L{lv}: run_all_levels time_ms")
    for f in ("gaussian", "box"):
        require(np.array_equal(results[(f, 1)]["image"], results[(f, 2)]["image"]),
                f"{f}: level 2 differs from level 1")
    rows = torch.from_numpy(image.reshape(h, w * c)).to(dev)
    plain = sobel.sobel_rows_plain(rows, w, c).cpu().numpy().reshape(FULL)
    sd = np.abs(results[("sobel", 2)]["image"].astype(int) - plain)
    require(sd.max() <= SOBEL_MAX_DIFF and (sd > 0).mean() <= SOBEL_MAX_FRACTION,
            f"sobel L2 vs plain L2: maxdiff {sd.max()}")
    print(f"API path checks: result dicts ok, gaussian/box L2 == L1, "
          f"sobel L2 vs plain maxdiff {sd.max()} fraction {(sd > 0).mean():.2e}")

    # The model's forward launches the rows kernel alone: no permute, no
    # copy of its table.  Then a Chrome trace of one API call
    # (`capture_trace`).
    image_t = torch.from_numpy(image).to(dev)
    model = GaussianBlur(MAIN_SIGMA, MAIN_GAUSS_RADIUS, 2).to(dev)
    model(image_t)
    torch.cuda.synchronize()
    with traced([dev]) as prof:
        model(image_t)
    forward_kernels = sorted({e.key for e in prof.key_averages()
                              if getattr(e, "device_time_total", 0) > 0
                              and PRIMER_KERNEL not in e.key})
    print(f"profiler: GaussianBlur(level=2) forward -> {forward_kernels} "
          f"(the session's primers kept: {primers_kept(prof.key_averages())} of "
          f"{PRIMERS})")
    require(forward_kernels and all("gauss_window_rows" in k for k in forward_kernels),
            f"the forward launches more than the rows kernel: {forward_kernels}")
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        capture_trace(lambda: rt.run("gaussian", image, level=2, sigma=MAIN_SIGMA,
                                     radius=MAIN_GAUSS_RADIUS), dev, trace_dir)
        with open(f"{trace_dir}/trace.json") as f:
            events = json.load(f)["traceEvents"]
        gauss_events = [e for e in events if "gauss_window_rows" in e.get("name", "")]
        require(gauss_events, "the Chrome trace of a served call shows no gaussian kernel")
        print(f"capture_trace: {len(events)} events in the Chrome trace of one API "
              f"call, {len(gauss_events)} of them the gaussian kernel")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    # -- 5. server path at full size ----------------------------------------
    # The single-image requests send a scene PNG filtered row by row as
    # common encoders write it, so the decode runs Average and Paeth; the
    # batch sends gradients (also filtered so), the only content whose four
    # PNGs fit the 64 MB body cap.
    t0 = time.perf_counter()
    scene = scene_image(rng)
    scene_png, scene_filters = client_png(scene)
    scene_b64 = "data:image/png;base64," + base64.b64encode(scene_png).decode()
    require(np.array_equal(decode_base64_image(scene_b64), scene),
            "the scene PNG does not decode to the scene")
    print(f"scene upload: PNG {len(scene_png) / 1e6:.2f} MB "
          f"({len(scene_png) / scene.size:.3f} of raw), rows per filter type "
          f"{scene_filters}")
    require(scene_filters.get(3, 0) > 0 and scene_filters.get(4, 0) > 0,
            f"the scene PNG has no Average or Paeth rows: {scene_filters}")
    grads = [gradient_image(rng, k) for k in range(4)]
    grad_pngs = [client_png(g) for g in grads]
    b64s = ["data:image/png;base64," + base64.b64encode(png).decode()
            for png, _ in grad_pngs]
    print(f"batch uploads: PNGs {[round(len(png) / 1e6, 2) for png, _ in grad_pngs]}"
          f" MB, rows per filter type {[f for _, f in grad_pngs]}; "
          f"{time.perf_counter() - t0:.1f} s to make the uploads")
    server = AppServer(create_app(rt), "127.0.0.1", 0)
    server.start_background()
    try:
        client = Client(f"http://127.0.0.1:{server.port}", card)
        status, health = client.get("/api/health")
        require(status == 200 and health.get("gpu_available") is True,
                f"/api/health: {status} {health}")
        status, catalog = client.get("/api/filters")
        require(status == 200 and set(catalog["filters"]) == {"gaussian", "box", "sobel"},
                f"/api/filters: {status}")

        pixels = decode_base64_image

        def direct(f: str, lv: int, sigma=MAIN_SIGMA, radius=None,
                   img=scene) -> np.ndarray:
            if f == "gaussian":
                return api.gaussian_blur(img, sigma, radius or MAIN_GAUSS_RADIUS,
                                         lv, runtime=rt)["image"]
            if f == "box":
                return api.box_blur(img, radius or MAIN_BOX_RADIUS, lv,
                                    runtime=rt)["image"]
            return api.sobel_edge_detection(img, lv, runtime=rt)["image"]

        params = {"gaussian": {"sigma": MAIN_SIGMA, "radius": MAIN_GAUSS_RADIUS},
                  "box": {"radius": MAIN_BOX_RADIUS}, "sobel": {}}
        torch.cuda.synchronize()
        LAUNCHES.clear()
        served = {}
        for f in ("gaussian", "box", "sobel"):
            status, out = client.post(
                "/api/process-all", {"image": scene_b64, "filter": f, **params[f]},
                f"{f} {w}x{h}")
            require(status == 200 and set(out["results"]) == {"level_1", "level_2"},
                    f"process-all {f}: {status} {str(out)[:200]}")
            require(out["profiling_available"] is False, "profiling_available")
            for lv in (1, 2):
                served[(f, lv)] = pixels(out["results"][f"level_{lv}"]["processed_image"])
        for f in ("gaussian", "box"):
            require(np.array_equal(served[(f, 1)], served[(f, 2)]),
                    f"process-all {f}: level_1 != level_2")
        # The same scene as a JPEG upload, as a phone's photo arrives,
        # written by the port's own encoder (baseline 4:4:4): /api/process-all
        # for each filter and /api/process at levels 1, 2 and 4.
        t0 = time.perf_counter()
        scene_jpeg = native_codec.jpeg_encode(scene, JPEG_QUALITY)
        jpeg_encode_ms = (time.perf_counter() - t0) * 1000.0
        jpeg_b64 = "data:image/jpeg;base64," + base64.b64encode(scene_jpeg).decode()
        jpeg_pixels = pixels(jpeg_b64)
        print(f"scene JPEG upload: {len(scene_jpeg) / 1e6:.2f} MB (quality "
              f"{JPEG_QUALITY}, 4:4:4), encoded in {jpeg_encode_ms:.1f} ms, decodes "
              f"within {int(np.abs(jpeg_pixels.astype(int) - scene).max())} of the scene")
        jpeg_before = client.get("/api/stats")[1]["decode_tiers"]["native_jpeg"]
        served_jpeg = {}
        for f in ("gaussian", "box", "sobel"):
            status, out = client.post(
                "/api/process-all", {"image": jpeg_b64, "filter": f, **params[f]},
                f"{f} JPEG {w}x{h}")
            require(status == 200 and set(out["results"]) == {"level_1", "level_2"},
                    f"process-all JPEG {f}: {status} {str(out)[:200]}")
            require(out["original_image"] == jpeg_b64,
                    f"process-all JPEG {f}: the original is not the upload passed through")
            for lv in (1, 2):
                served_jpeg[(f, lv)] = pixels(out["results"][f"level_{lv}"]["processed_image"])
            if f == "gaussian":   # phase 11's answer to match
                jpeg_answer = {lv: out["results"][f"level_{lv}"]["processed_image"]
                               for lv in (1, 2)}
        for lv in (1, 2, 4):
            status, out = client.post(
                "/api/process", {"image": jpeg_b64, "filter": "gaussian", "level": lv,
                                 **params["gaussian"]}, f"gaussian L{lv} JPEG {w}x{h}")
            require(status == 200, f"process JPEG gaussian L{lv}: {status} {str(out)[:200]}")
            served_jpeg[("process gaussian", lv)] = pixels(out["processed_image"])
        jpeg_count = client.get("/api/stats")[1]["decode_tiers"]["native_jpeg"] - jpeg_before
        require(jpeg_count == 6, f"decode_tiers.native_jpeg counted {jpeg_count} of 6 "
                                 f"JPEG requests")
        # Deep profiles of the scene's process-all, each level traced with
        # torch.profiler on the card.
        profiled = {}
        for f in ("gaussian", "box", "sobel"):
            status, out = client.post(
                "/api/process-all", {"image": scene_b64, "filter": f, **params[f],
                                     "enable_profiling": True},
                f"{f} profiled {w}x{h}")
            require(status == 200 and out["profiling_available"] is True,
                    f"profiled process-all {f}: {status} {str(out)[:200]}")
            for lv in (1, 2):
                m = out["results"][f"level_{lv}"]["metrics"]
                require("profiling_error" not in m,
                        f"profiled {f} L{lv}: {m.get('profiling_error')}")
                profiled[(f, lv)] = m
        level4 = [("gaussian", 2, 1.5), ("gaussian", 3, MAIN_SIGMA),
                  ("gaussian", 15, 5.0), ("box", MAIN_BOX_RADIUS, None),
                  ("sobel", None, None)]
        served4 = {}
        for f, radius, sigma in level4:
            payload = {"image": scene_b64, "filter": f, "level": 4}
            if radius:
                payload["radius"] = radius
            if sigma:
                payload["sigma"] = sigma
            status, out = client.post("/api/process", payload,
                                      f"{f} L4 r={radius} {w}x{h}")
            require(status == 200, f"process {f} L4 r={radius}: {status} {out}")
            require(out["info"]["level"] == "advanced", f"level name {out['info']}")
            served4[(f, radius)] = pixels(out["processed_image"])
        batches = {}
        for f in ("gaussian", "box", "sobel"):
            for lv in (2, 4):
                payload = {"images": b64s, "filter": f, "level": lv, **params[f],
                           "enable_profiling": (f, lv) == ("gaussian", 2)}
                size = len(json.dumps(payload))
                require(size < BODY_CAP, f"batch body {size} bytes over the cap")
                status, out = client.post("/api/process-batch", payload,
                                          f"{f} L{lv} 4x{w}x{h}")
                require(status == 200 and len(out["processed_images"]) == 4,
                        f"process-batch {f} L{lv}: {status} {str(out)[:200]}")
                require(out["metrics"]["batch_size"] == 4, f"batch metrics {out['metrics']}")
                if payload["enable_profiling"]:
                    m = out["metrics"]
                    require("profiling_error" not in m and m["kernel_duration_source"]
                            == "torch_profiler_trace",
                            f"profiled batch: {m.get('profiling_error')}")
                    print(f"[{card}] profiled process-batch {f} L{lv}: time_ms "
                          f"{m['time_ms']:.4f}, ncu_profiled_time_ms "
                          f"{m['ncu_profiled_time_ms']:.4f}, rows " + "; ".join(
                              f"{short_kernel_name(k)} {v:.4f} ms" for k, v in
                              m["ncu_data"]["kernel_durations_ms"].items()))
                print(f"[{card}] process-batch {f} L{lv}: time_ms "
                      f"{out['metrics']['time_ms']:.4f} for 4 images, "
                      f"images_per_second {out['metrics']['images_per_second']:.1f}")
                batches[(f, lv)] = [pixels(s) for s in out["processed_images"]]
                for i, b64 in enumerate(b64s):
                    status, one = client.post(
                        "/api/process", {"image": b64, "filter": f, "level": lv,
                                         **params[f]}, f"{f} L{lv} image {i}")
                    require(status == 200, f"process {f} L{lv} image {i}: {status}")
                    require(np.array_equal(pixels(one["processed_image"]),
                                           batches[(f, lv)][i]),
                            f"process-batch {f} L{lv}: image {i} differs from "
                            f"/api/process")
        status, out = client.post(
            "/api/process", {"image": b64s[0], "filter": "gaussian", "level": 5},
            "error probe level 5")
        require(status == 400 and "Invalid level" in out.get("detail", ""),
                f"level 5: {status} {out}")
        torch.cuda.synchronize()
        server_launches = {name: LAUNCHES[name] for name in ROWS_KERNELS}
        status, stats = client.get("/api/stats")
        require(status == 200, "/api/stats")
    finally:
        server.shutdown()
    print(f"server path launches: {server_launches}")
    for name, n in server_launches.items():
        require(n > 0, f"server path never launched {name}")
    print(f"server phase totals (host clock, ms): {json.dumps(stats['phase_ms'])}")
    print(f"server decode tiers: {json.dumps(stats['decode_tiers'])}")

    # The JPEG requests: levels equal, and equal to the API on the pixels
    # the server decoded.
    for f in ("gaussian", "box", "sobel"):
        for lv in (1, 2):
            require(np.array_equal(served_jpeg[(f, lv)], direct(f, lv, img=jpeg_pixels)),
                    f"process-all JPEG {f} level_{lv} differs from the API call")
    for f in ("gaussian", "box"):
        require(np.array_equal(served_jpeg[(f, 1)], served_jpeg[(f, 2)]),
                f"process-all JPEG {f}: level_1 != level_2")
    for lv in (1, 2):
        require(np.array_equal(served_jpeg[("process gaussian", lv)],
                               served_jpeg[("gaussian", lv)]),
                f"process JPEG gaussian L{lv} differs from process-all")
    d = int(np.abs(served_jpeg[("process gaussian", 4)].astype(int)
                   - served_jpeg[("gaussian", 2)]).max())
    require(d <= 1, f"process JPEG gaussian L4: maxdiff {d} vs level 2")
    print(f"JPEG requests: the original passed through, levels 1 and 2 equal and "
          f"equal to the API on the decoded pixels, level 4 within {d} of level 2, "
          f"decode_tiers.native_jpeg counted all 6")

    # The deep profiles: level 2 traced the hand kernel alone, and its
    # profiled time agrees with the runtime's time_ms.
    for (f, lv), m in profiled.items():
        deep = m["ncu_data"]
        require(m["kernel_duration_source"] == "torch_profiler_trace",
                f"profiled {f} L{lv}: duration source {m['kernel_duration_source']}")
        kernel_rows = deep["kernel_durations_ms"]
        counts = {k: v["count"] for k, v in deep["trace_kernel_stats"].items()}
        print(f"[{card}] profile {f} L{lv}: time_ms {m['time_ms']:.4f}, "
              f"ncu_profiled_time_ms {m['ncu_profiled_time_ms']:.4f}, "
              f"sessions {deep['config']['Trace Sessions']}, primers kept "
              f"{deep['config']['Trace Primers Kept']}, DRAM "
              f"{m.get('dram_throughput_pct', float('nan')):.1f}% of peak, peak "
              f"device memory {m.get('peak_device_memory_bytes', 0) / 1e6:.1f} MB, "
              f"{len(kernel_rows)} device rows, the first: " + "; ".join(
                  f"{short_kernel_name(k)} {v:.4f} ms x{counts[k]}"
                  for k, v in list(kernel_rows.items())[:4]))
        if lv == 2:
            hand = KERNELS[f"{f}_rows"]["profiler_names"]
            require(all(any(n in k for n in hand) for k in m["kernels_profiled"]),
                    f"profiled {f} L2 lists other kernels: {m['kernels_profiled']}")
    g = profiled[("gaussian", 2)]
    ratio = g["ncu_profiled_time_ms"] / g["time_ms"]
    require(abs(ratio - 1) <= 0.15,
            f"gaussian L2: profiled {g['ncu_profiled_time_ms']:.4f} ms against "
            f"time_ms {g['time_ms']:.4f} ms")
    print(f"profiles: level 2 lists the hand kernels alone; gaussian L2 profiled "
          f"time / time_ms {ratio:.3f}")

    # The served pixels against direct calls and the level-2 / plain results.
    for (f, lv), got in served.items():
        require(np.array_equal(got, direct(f, lv)),
                f"process-all {f} level_{lv} differs from the API call")
    for radius, sigma in ((2, 1.5), (3, MAIN_SIGMA), (15, 5.0)):
        d = int(np.abs(served4[("gaussian", radius)].astype(int)
                       - direct("gaussian", 2, sigma, radius)).max())
        print(f"gaussian L4 r={radius} vs L2 {w}x{h}: maxdiff {d}")
        require(d <= 1, f"gaussian L4 r={radius}: maxdiff {d} vs level 2")
    require(np.array_equal(served4[("box", MAIN_BOX_RADIUS)], direct("box", 2)),
            "box L4 != L2")
    scene_rows = torch.from_numpy(scene.reshape(h, w * c)).to(dev)
    sobel_l1 = interleaved.sobel_rows(scene_rows, 1, w, c).cpu().numpy().reshape(FULL)
    require(np.array_equal(served4[("sobel", None)], sobel_l1),
            "sobel L4 != the plain level-1 function")
    for f in ("gaussian", "box", "sobel"):
        require(np.array_equal(batches[(f, 2)][0], direct(f, 2, img=grads[0])),
                f"process-batch {f} L2 image 0 differs from the API call")
    print("server checks: process-all levels equal and equal to the API, level 4 "
          "within 1 (gaussian) / equal (box, sobel vs plain L1), batches equal "
          "per-image requests, level 5 -> 400")

    # -- 6. planar path at full size ------------------------------------------
    # 6a. The models, the registry and the flagship entry on (H, W, C)
    # tensors on the card, each against the interleaved API on the same
    # image: forward at levels 2 and 4 is the level-2 function, the "_adv"
    # keys level 4.  The tier runs the rows kernels on the (H, W*C) view of
    # each image, so no planar kernel launches here; only the level-4 band
    # runs on planes.
    rgba = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    registry: dict = {}
    fused.register_all(registry.__setitem__)
    w15 = weights_to_torch(gaussian_kernel_f32(15, 5.0), dev)
    pipeline = nn.Sequential(GaussianBlur(MAIN_SIGMA, MAIN_GAUSS_RADIUS, 2),
                             SobelEdgeDetection(2)).to(dev)
    forward, (entry_img, entry_w) = entry(dev)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    planar = {
        "GaussianBlur L1": GaussianBlur(MAIN_SIGMA, MAIN_GAUSS_RADIUS, 1).to(dev)(image_t),
        "GaussianBlur L2": GaussianBlur(MAIN_SIGMA, MAIN_GAUSS_RADIUS, 2).to(dev)(image_t),
        "GaussianBlur L4": GaussianBlur(MAIN_SIGMA, MAIN_GAUSS_RADIUS, 4).to(dev)(image_t),
        "BoxBlur r=5": BoxBlur(MAIN_BOX_RADIUS, 2)(image_t),
        "BoxBlur r=40": BoxBlur(40, 2)(image_t),
        "SobelEdgeDetection L1": SobelEdgeDetection(1)(image_t),
        "SobelEdgeDetection L2": SobelEdgeDetection(2)(image_t),
        "gaussian": registry["gaussian"](image_t, w3_host, MAIN_GAUSS_RADIUS),
        "gaussian_adv r=2": registry["gaussian_adv"](image_t, w2_host, FOLDED_RADIUS),
        "gaussian_adv r=15": registry["gaussian_adv"](image_t, w15, 15),
        "box": registry["box"](image_t, MAIN_BOX_RADIUS),
        "box_adv": registry["box_adv"](image_t, MAIN_BOX_RADIUS),
        "sobel": registry["sobel"](image_t),
        "sobel_adv": registry["sobel_adv"](image_t),
        "Sequential(GaussianBlur, Sobel)": pipeline(image_t),
        "SobelEdgeDetection L2 RGBA": SobelEdgeDetection(2)(torch.from_numpy(rgba).to(dev)),
    }
    entry_out = forward(entry_img, entry_w)
    torch.cuda.synchronize()
    planar_wall = (time.perf_counter() - t0) * 1000.0
    tier_launches = {name: LAUNCHES[name] for name in KERNELS}
    print(f"planar path launches: {tier_launches} ({len(planar) + 1} calls "
          f"in {planar_wall:.1f} ms, host clock)")
    for name in ROWS_KERNELS:
        require(tier_launches[name] > 0, f"planar path never launched {name}")
    for name in PLANAR_KERNELS:
        require(tier_launches[name] == 0,
                f"planar path launched {name} on a call without halo rows")

    gauss_l2 = results[("gaussian", 2)]["image"]
    sobel_l2 = results[("sobel", 2)]["image"]
    want = {
        "GaussianBlur L1": results[("gaussian", 1)]["image"],
        "GaussianBlur L2": gauss_l2,
        "GaussianBlur L4": gauss_l2,
        "BoxBlur r=5": results[("box", 2)]["image"],
        "BoxBlur r=40": api.box_blur(image, 40, 2, runtime=rt)["image"],
        "SobelEdgeDetection L1": results[("sobel", 1)]["image"],
        "SobelEdgeDetection L2": sobel_l2,
        "gaussian": gauss_l2,
        "gaussian_adv r=2": api.gaussian_blur(image, 1.5, FOLDED_RADIUS, 4, runtime=rt)["image"],
        "gaussian_adv r=15": api.gaussian_blur(image, 5.0, 15, 4, runtime=rt)["image"],
        "box": results[("box", 2)]["image"],
        "box_adv": api.box_blur(image, MAIN_BOX_RADIUS, 4, runtime=rt)["image"],
        "sobel": sobel_l2,
        "sobel_adv": api.sobel_edge_detection(image, 4, runtime=rt)["image"],
        "Sequential(GaussianBlur, Sobel)": api.sobel_edge_detection(
            gauss_l2, 2, runtime=rt)["image"],
        "SobelEdgeDetection L2 RGBA": api.sobel_edge_detection(rgba, 2, runtime=rt)["image"],
    }
    # Colour Sobel with the quantized grey, held to its tolerance.
    colour_sobel_l2 = {"SobelEdgeDetection L2", "sobel",
                           "Sequential(GaussianBlur, Sobel)",
                           "SobelEdgeDetection L2 RGBA"}
    # The band on planes against the band on rows: the tensor cores sum the
    # two layouts in other orders (depth 16 + 2r against 16 + 2rC), so the
    # band's tolerance.
    band_keys = {"gaussian_adv r=15"}

    def check_planar(got_by_key: dict, want_by_key: dict, what: str) -> dict:
        diffs = {}
        for key, got in got_by_key.items():
            got = got.cpu().numpy()
            require(got.shape == want_by_key[key].shape and got.dtype == np.uint8,
                    f"{what} {key}: {got.shape} {got.dtype}")
            d = np.abs(got.astype(int) - want_by_key[key])
            diffs[key] = int(d.max())
            if key in colour_sobel_l2:
                require(d.max() <= SOBEL_MAX_DIFF and (d > 0).mean() <= SOBEL_MAX_FRACTION,
                        f"{what} {key} vs API: maxdiff {d.max()}")
            elif key in band_keys:
                require(d.max() <= blur.BAND_MAX_DIFF
                        and (d > 0).mean() <= blur.BAND_MAX_FRACTION,
                        f"{what} {key} vs API: maxdiff {d.max()}, "
                        f"{int((d > 0).sum())} bytes differ")
            else:
                require(d.max() == 0, f"{what} {key} vs API: maxdiff {d.max()}")
        return diffs

    diffs = check_planar(planar, want, "planar")
    require(torch.equal(entry_out, fused.gaussian_fused(entry_img, entry_w, 3)),
            "entry() on the card differs from its plain version")
    print(f"planar path vs the interleaved API at {w}x{h}: maxdiff " + ", ".join(
        f"{k} {d}" for k, d in diffs.items()) + f"; entry() {tuple(entry_out.shape)} "
        f"equals its plain version")

    # 6b. The planes path: K5 and K7 where the rows kernels do not serve, at
    # full size: row bands given with their halo rows (as the bands of a
    # split image carry them), the Sobel batch with zero_rows=False, and
    # images past the rows kernels' channel caps (33 channels), through the
    # planar functions and the registry a caller uses.
    a, z = BAND_ROWS
    image_planes = planar_api.to_planes(image_t)
    wide = rng.integers(0, 256, size=(h // 2, w // 2, blur.GAUSS_MAX_CHANNELS + 1),
                        dtype=np.uint8)
    wide_t = torch.from_numpy(wide).to(dev)
    halo = {r: image_planes[:, a - r:z + r].contiguous() for r in (1, r2, r3, br)}
    halo_imgs = image_t[None, a - 1:z + 1].contiguous()
    torch.cuda.synchronize()
    LAUNCHES.clear()
    planes_path = {
        "gaussian_planar band": blur_planar.gaussian_planar(
            halo[r3], w3_host, r3, rows_prepadded=True),
        "gaussian_folded_planar band": blur_planar.gaussian_folded_planar(
            halo[r2], w2_host, r2, rows_prepadded=True),
        "box_planar band": blur_planar.box_planar(halo[br], br, rows_prepadded=True),
        "sobel_planar_batch L2 band": planar_api.sobel_planar_batch(
            halo_imgs, 2, rows_prepadded=True, zero_rows=False),
        "sobel_planar_batch L1 band": planar_api.sobel_planar_batch(
            halo_imgs, 1, rows_prepadded=True, zero_rows=False),
        "sobel_planar_batch L2 zero_rows=False": planar_api.sobel_planar_batch(
            image_t[None], 2, zero_rows=False),
        "gaussian 33 channels": registry["gaussian"](wide_t, w3_host, r3),
        "gaussian_adv r=2 33 channels": registry["gaussian_adv"](wide_t, w2_host, r2),
        "box 33 channels": registry["box"](wide_t, br),
    }
    torch.cuda.synchronize()
    planes_launches = {name: LAUNCHES[name] for name in PLANAR_KERNELS}
    print(f"planes path launches: {planes_launches} ({len(planes_path)} calls)")
    for name, n in planes_launches.items():
        require(n > 0, f"planes path never launched {name}")
    wide_rows = wide_t.view(h // 2, -1)
    wc = wide.shape[-1]
    sobel_keep = sobel_planar.sobel_planar_plain(
        image_planes, 2, zero_rows=False).permute(1, 2, 0)[None]
    want_planes = {
        "gaussian_planar band": np.ascontiguousarray(gauss_l2[a:z].transpose(2, 0, 1)),
        "gaussian_folded_planar band": np.ascontiguousarray(
            want["gaussian_adv r=2"][a:z].transpose(2, 0, 1)),
        "box_planar band": np.ascontiguousarray(
            results[("box", 2)]["image"][a:z].transpose(2, 0, 1)),
        "sobel_planar_batch L2 band": sobel_l2[None, a:z],
        "sobel_planar_batch L1 band": results[("sobel", 1)]["image"][None, a:z],
        "sobel_planar_batch L2 zero_rows=False": sobel_keep.cpu().numpy(),
        "gaussian 33 channels": interleaved.gaussian_rows(
            wide_rows, w3, r3, wc).view(wide_t.shape).cpu().numpy(),
        "gaussian_adv r=2 33 channels": interleaved.gaussian_rows_folded(
            wide_rows, w2, r2, wc).view(wide_t.shape).cpu().numpy(),
        "box 33 channels": interleaved.box_rows(
            wide_rows, br, wc).view(wide_t.shape).cpu().numpy(),
    }
    colour_sobel_l2 |= {"sobel_planar_batch L2 band",
                        "sobel_planar_batch L2 zero_rows=False"}
    diffs = check_planar(planes_path, want_planes, "planes path")
    print(f"planes path at {w}x{h} (bands of rows {a}-{z}, {wide.shape} images): "
          f"maxdiff " + ", ".join(f"{k} {d}" for k, d in diffs.items())
          + " against the API's rows and the plain versions")
    del halo, halo_imgs, sobel_keep, want_planes

    with traced([dev]) as prof:
        for lv in (2, 4):
            for radius in (FOLDED_RADIUS, MAIN_GAUSS_RADIUS):
                rt.run("gaussian", scene, level=lv, sigma=MAIN_SIGMA, radius=radius)
            rt.run("box", scene, level=lv, radius=MAIN_BOX_RADIUS)
            rt.run("sobel", scene, level=lv)
        registry["gaussian"](image_t, w3_host, MAIN_GAUSS_RADIUS)
        registry["gaussian_adv"](image_t, w2_host, FOLDED_RADIUS)
        registry["box"](image_t, MAIN_BOX_RADIUS)
        registry["sobel"](image_t)
        registry["sobel_adv"](image_t)
        registry["gaussian"](wide_t, w3_host, r3)
        registry["gaussian_adv"](wide_t, w2_host, r2)
        registry["box"](wide_t, br)
        registry["box"](wide_t, 15)
        planar_api.sobel_planar_batch(image_t[None], 2, zero_rows=False)
        planar_api.sobel_planar_batch(image_t[None], 1, zero_rows=False)
        rt.run("box", scene, level=2, radius=15)    # box_rows's running sums
        rt.run("box", scene, level=2, radius=100)   # box_rows's two-launch route
        rt.run("gaussian", scene, level=2, sigma=20.0, radius=15)   # gauss_pair_rows
    device_kernels = [e.key for e in prof.key_averages()
                      if getattr(e, "device_time_total", 0) > 0
                      and PRIMER_KERNEL not in e.key]
    for name, spec in KERNELS.items():
        for sub in spec["profiler_names"]:
            hits = [k for k in device_kernels if sub in k]
            require(hits, f"profiler lists no device kernel named {sub}")
            print(f"profiler: {name} -> {hits[0]}")
    # -- 7. times -------------------------------------------------------------
    # Request time: the host clock around a whole API call, copies to and
    # from the card included (the call returns a numpy image, so it has
    # waited for the device).  Least of 3.
    for f in calls:
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            calls[f](2)
            walls.append((time.perf_counter() - t0) * 1000.0)
        print(f"[{card}] {f} L2 {w}x{h}x{c}: API call wall {min(walls):.3f} ms "
              f"(host clock, copies included)")

    def event_ms(fn, iters=20) -> float:
        # Untimed launches first: a card that idled (the host-bound server
        # phase) raises its clocks only under load.  The card then sleeps
        # (about 25 ms) while the host queues the timed launches, so the
        # events time the kernels, not the wrappers' host work between them.
        for _ in range(10):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    main_radius = {"gaussian_rows": MAIN_GAUSS_RADIUS, "box_rows": MAIN_BOX_RADIUS,
                   "gaussian_folded_rows": FOLDED_RADIUS,
                   "gaussian_band_rows": MAIN_GAUSS_RADIUS,
                   "sobel_rows": 1, "sobel_f32_rows": 1}
    arms = {}
    for radius, sigma in ((FOLDED_RADIUS, 1.5), (MAIN_GAUSS_RADIUS, MAIN_SIGMA)):
        for name, pair in launchers(dev, radius, sigma, MAIN_BOX_RADIUS,
                                    w, c).items():
            if main_radius[name] == radius or name.startswith(("box", "sobel")):
                arms.setdefault(name, pair)
    times, bounds = {}, {}

    def time_kernel(name, kernel, plain_fn, x, radius):
        # plain, kernel, kernel, plain: drift hits both arms alike.
        fn_k, fn_p = (lambda: kernel(x)), (lambda: plain_fn(x))
        p1, k1, k2, p2 = event_ms(fn_p), event_ms(fn_k), event_ms(fn_k), event_ms(fn_p)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        bounds[name] = bound(name, FULL, radius)
        print(f"[{card}] {name} {w}x{h}x{c} r={radius}: kernel "
              f"{times[name][0]:.4f} ms ({k1:.4f}, {k2:.4f}), plain torch "
              f"{times[name][1]:.4f} ms ({p1:.4f}, {p2:.4f}), bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), "
              f"{times[name][0] / bounds[name][0]:.1f}x the bound")

    for name, (kernel, plain_fn) in arms.items():
        time_kernel(name, kernel, plain_fn, rows, main_radius[name])
    # The gaussian, box and the band at their other radii: box to a radius
    # wider than the image, the gaussian and the band to the cap.
    for name, table in (("gaussian_rows", ((1, 1.0), (15, 8.0), GAUSS_RUNTIME_RADIUS,
                                           (31, 8.0))),
                        ("gaussian_folded_rows", ((1, 1.0),))):
        for radius, sigma in table:
            fn, _ = launchers(dev, radius, sigma, MAIN_BOX_RADIUS, w, c)[name]
            least, by = bound(name, FULL, radius)
            print(f"[{card}] {name} {w}x{h}x{c} r={radius}: kernel "
                  f"{event_ms(lambda: fn(rows)):.4f} ms, bound {least:.4f} ms ({by})")
    for radius in [r for r in BOX_RADII + BOX_WIDE_RADII if r != MAIN_BOX_RADIUS]:
        least, by = bound("box_rows", FULL, radius)
        print(f"[{card}] box_rows {w}x{h}x{c} r={radius}: kernel "
              f"{event_ms(lambda: blur.box_rows(rows, radius, c)):.4f} ms, bound "
              f"{least:.4f} ms ({by})")
    for radius, sigma in ((15, 5.0), (31, 8.0)):
        band_k, band_p = launchers(dev, radius, sigma, MAIN_BOX_RADIUS, w, c)[
            "gaussian_band_rows"]
        least, by = bound("gaussian_band_rows", FULL, radius)
        print(f"[{card}] gaussian_band_rows {w}x{h}x{c} r={radius}: kernel "
              f"{event_ms(lambda: band_k(rows)):.4f} ms, plain torch "
              f"{event_ms(lambda: band_p(rows), 5):.4f} ms, bound {least:.4f} ms ({by})")
    # The planar kernels on the (3, H, W) planes of the same image.
    planes_full = planar_api.to_planes(image_t)
    planar_radius = {"gaussian_planar": MAIN_GAUSS_RADIUS,
                     "gaussian_folded_planar": FOLDED_RADIUS,
                     "box_planar": MAIN_BOX_RADIUS, "sobel_planar": 1,
                     "sobel_f32_planar": 1}
    planar_arms = planar_launchers(dev, MAIN_GAUSS_RADIUS, MAIN_SIGMA, MAIN_BOX_RADIUS)
    planar_arms["gaussian_folded_planar"] = planar_launchers(
        dev, FOLDED_RADIUS, 1.5, MAIN_BOX_RADIUS)["gaussian_folded_planar"]
    for name, (kernel, plain_fn) in planar_arms.items():
        time_kernel(name, kernel, plain_fn, planes_full, planar_radius[name])
    # The batch forms: 4 full-size images in one launch, K7 on (4, 3, H, W)
    # and K5 on their 12 planes; K5 and K7 in their halo-row modes.
    batch4 = planes_full.unsqueeze(0).repeat(4, 1, 1, 1)
    band3 = planes_full[:, a - r3:z + r3].contiguous()
    band1 = planes_full[None, :, a - 1:z + 1].contiguous()
    for name, what, fn, shape in (
            ("sobel_planar", f"on 4 images (4, {c}, {h}, {w})",
             lambda: sobel_planar.sobel_planar(batch4), (4, *FULL)),
            ("gaussian_planar", f"on 4 images ({4 * c}, {h}, {w})",
             lambda: blur_planar.gaussian_planar(batch4.view(4 * c, h, w), w3_host, r3),
             (4, *FULL)),
            ("gaussian_planar", f"rows {a}-{z} with halo rows",
             lambda: blur_planar.gaussian_planar(band3, w3_host, r3, True),
             (z - a, w, c)),
            ("sobel_planar", f"rows {a}-{z} with halo rows, zero_rows=False",
             lambda: sobel_planar.sobel_planar(band1, True, False), (z - a, w, c))):
        least, by = bound(name, shape, r3)
        print(f"[{card}] {name} {what}: kernel {event_ms(fn):.4f} ms, bound "
              f"{least:.4f} ms ({by})")
    del batch4, band3, band1
    # The rows kernels' batch form (B: the batch on grid z) on 4 full-size
    # images, beside its plain version.
    rows4 = rows.unsqueeze(0).repeat(4, 1, 1)
    for name, (kernel, plain_fn) in arms.items():
        if name in ("gaussian_rows", "sobel_rows"):
            least, by = bound(name, (4, *FULL), main_radius[name])
            print(f"[{card}] {name} on 4 images (4, {h}, {w * c}): kernel "
                  f"{event_ms(lambda: kernel(rows4)):.4f} ms, plain torch "
                  f"{event_ms(lambda: plain_fn(rows4), 5):.4f} ms, bound "
                  f"{least:.4f} ms ({by})")
    del rows4
    # The band (level-4 gaussian from r = 3) launched on the planes.
    for radius, sigma in ((MAIN_GAUSS_RADIUS, MAIN_SIGMA), (15, 5.0), (31, 8.0)):
        hi, lo = (weights_to_torch(t, dev)
                  for t in bf16_split(gaussian_kernel_f32(radius, sigma)))
        k = event_ms(lambda: blur.gaussian_band_rows(planes_full, hi, lo, radius, 1))
        least, by = bound("gaussian_band_rows", FULL, radius)
        print(f"[{card}] gaussian_band_rows on (3, {h}, {w}) planes r={radius}: "
              f"kernel {k:.4f} ms, bound {least:.4f} ms ({by})")
    # The API's time_ms (runtime/timing.py: the card's queue filled before
    # the start event) beside its kernel's event time and, at level 1, the
    # plain version's; least of 3 calls.
    kernel_of = {"gaussian": "gaussian_rows", "box": "box_rows", "sobel": "sobel_rows"}
    for f in calls:
        for lv in (1, 2):
            res = [calls[f](lv) for _ in range(3)]
            tm = min(r["time_ms"] for r in res)
            each = ", ".join("%.4f" % r["time_ms"] for r in res)
            k_ms, p_ms = times[kernel_of[f]]
            ref_ms, what = (k_ms, "kernel") if lv == 2 else (p_ms, "plain torch")
            print(f"[{card}] {f} L{lv} {w}x{h}x{c}: time_ms {tm:.4f} "
                  f"({each}), {what} "
                  f"events {ref_ms:.4f} ms, time_ms / events {tm / ref_ms:.3f}; "
                  f"bandwidth_gbps {res[0]['bandwidth_gbps']:.2f}, "
                  f"fps {res[0]['fps']:.1f}")
    # The old planar kernels against these: tools/kernel_times.py --ref
    # times two checkouts in one process (README).
    # The models' forward: the rows kernel on the (H, W*C) view, no
    # permutes.  Host clock around a call that ends in a synchronize, least
    # of 5, and CUDA events.
    for label, fwd, kernel_name in (
            ("GaussianBlur(level=2)", GaussianBlur(MAIN_SIGMA, MAIN_GAUSS_RADIUS, 2).to(dev),
             "gaussian_rows"),
            ("SobelEdgeDetection(level=2)", SobelEdgeDetection(2), "sobel_rows")):
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(image_t)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1000.0)
        print(f"[{card}] {label} forward {w}x{h}x{c}: wall {min(walls):.4f} ms "
              f"(host clock, least of 5), CUDA events "
              f"{event_ms(lambda: fwd(image_t)):.4f} ms, of which the kernel "
              f"{times[kernel_name][0]:.4f} ms")
    # -- 7b. served through the executables' graphs --------------------------
    graph_phase(rt, card, image, scene, scene_b64, grads, served, served4, batches)

    # -- 8. multi-device path on one card -----------------------------------
    # A mesh may name one device several times: 4 shards on this card, as
    # (dp, sp) = (2, 2) and (1, 4), rows exchanged as halo copies within the
    # card.  K5 runs in its halo mode (rows_prepadded) and K6 with
    # zero_rows=False, one launch a shard; the mesh batch runs the rows
    # kernels, one launch a block.  Every result equals one device's.
    t8 = time.perf_counter()
    cards4 = [dev] * 4
    meshes = {"(2, 2)": make_mesh(4, devices=cards4),
              "(1, 4)": make_mesh(4, sp=4, devices=cards4)}
    table3 = gaussian_kernel_f32(MAIN_GAUSS_RADIUS, MAIN_SIGMA)
    batch4 = np.stack([image] + [rng.integers(0, 256, size=FULL, dtype=np.uint8)
                                 for _ in range(3)])
    # name -> (filter, builder kwargs, API level, the kernel a shard launches)
    sharded_specs = {
        "gaussian r=3": ("gaussian", dict(radius=MAIN_GAUSS_RADIUS), 2,
                         "gaussian_planar"),
        "box r=5": ("box", dict(radius=MAIN_BOX_RADIUS), 2, "box_planar"),
        "sobel L2": ("sobel", dict(level=2), 2, "sobel_planar"),
        "sobel L1": ("sobel", dict(level=1), 1, "sobel_f32_planar"),
    }

    def single_device(f: str, lv: int, img: np.ndarray) -> np.ndarray:
        if f == "gaussian":
            return api.gaussian_blur(img, MAIN_SIGMA, MAIN_GAUSS_RADIUS, lv,
                                     runtime=rt)["image"]
        if f == "box":
            return api.box_blur(img, MAIN_BOX_RADIUS, lv, runtime=rt)["image"]
        return api.sobel_edge_detection(img, lv, runtime=rt)["image"]

    want4 = {name: np.stack([single_device(f, lv, img) for img in batch4])
             for name, (f, _, lv, _) in sharded_specs.items()}
    cases = {"1 image": slice(0, 1), "4 images": slice(0, 4),
             "3 images (uneven B, H 2146 over sp)": slice(0, 3)}
    torch.cuda.synchronize()
    LAUNCHES.clear()
    sharded_calls = {name: 0 for name in PLANAR_KERNELS}
    for mesh_name, mesh in meshes.items():
        for name, (f, kw, lv, kernel) in sharded_specs.items():
            fns = [make_sharded_filter(mesh, f, use_kernels=k, **kw)
                   for k in (True, False)]
            for case, sel in cases.items():
                imgs = batch4[sel]
                got, plain = (fn(imgs, table3) if f == "gaussian" else fn(imgs)
                              for fn in fns)
                sharded_calls[kernel] += 1
                got, plain = got.cpu().numpy(), plain.cpu().numpy()
                require(got.shape == imgs.shape,
                        f"sharded {name} on {mesh_name}, {case}: {got.shape}")
                require(np.array_equal(got, want4[name][sel]),
                        f"sharded {name} on mesh {mesh_name}, {case}: differs "
                        f"from the single-device API")
                require(np.array_equal(plain, got),
                        f"sharded {name} on mesh {mesh_name}, {case}: the plain "
                        f"bodies differ from the kernels")
    torch.cuda.synchronize()
    sharded_launches = {name: LAUNCHES[name] for name in KERNELS}
    print(f"sharded filters launches: {sharded_launches} (4 shards x calls "
          f"{sharded_calls})")
    for name in KERNELS:
        require(sharded_launches[name] == 4 * sharded_calls.get(name, 0),
                f"sharded filters launched {name} {sharded_launches[name]} times, "
                f"not 4 x {sharded_calls.get(name, 0)}")
    print(f"sharded filters at {w}x{h}x{c} on meshes {', '.join(meshes)} of "
          f"cuda:0 x 4 ({', '.join(cases)}): gaussian r=3, box r=5, sobel L2, L1 "
          f"equal the single-device API bit for bit, and the plain bodies")

    # Serving: row-sharded single images and the mesh batch through a
    # runtime whose mesh names this card 4 times, against the one-device
    # runtime `rt`.  The switches are restored whatever happens.
    rt_mesh = FilterRuntime(dev, mesh_devices=cards4)
    serve_kw = {"gaussian": dict(sigma=MAIN_SIGMA, radius=MAIN_GAUSS_RADIUS),
                "box": dict(radius=MAIN_BOX_RADIUS), "sobel": {}}
    spatial_cases = [("gaussian", 1), ("gaussian", 2), ("gaussian", 4),
                     ("box", 2), ("sobel", 1), ("sobel", 2), ("sobel", 4)]
    sobel_l4 = calls["sobel"](4)["image"]
    single_batch = {(f, lv): rt.run_batch(f, batch4, level=lv, **serve_kw[f])
                    for f in serve_kw for lv in (2, 4)}
    switches = ("GIP_TPU_MESH_SPATIAL", "GIP_TPU_MESH_BATCH",
                "GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD")
    saved = {k: os.environ.get(k) for k in switches}
    try:
        for k in switches:
            os.environ.pop(k, None)
        os.environ["GIP_TPU_MESH_SPATIAL"] = "1"
        torch.cuda.synchronize()
        LAUNCHES.clear()
        served = {(f, lv): rt_mesh.run(f, image, level=lv, **serve_kw[f])
                  for f, lv in spatial_cases}
        torch.cuda.synchronize()
        spatial_launches = {name: LAUNCHES[name] for name in KERNELS}
        os.environ.pop("GIP_TPU_MESH_SPATIAL")
        os.environ["GIP_TPU_MESH_BATCH"] = "1"
        LAUNCHES.clear()
        mesh_batch = {key: rt_mesh.run_batch(key[0], batch4, level=key[1],
                                             **serve_kw[key[0]])
                      for key in single_batch}
        torch.cuda.synchronize()
        mesh_batch_launches = {name: LAUNCHES[name] for name in KERNELS}
        # Profiled requests on these deployments profile the sharded calls.
        deep = {"batch": profile_batch(rt_mesh, batch4, "gaussian", 2,
                                       **serve_kw["gaussian"])}
        os.environ.pop("GIP_TPU_MESH_BATCH")
        os.environ["GIP_TPU_MESH_SPATIAL"] = "1"
        deep["spatial"] = profile_filter(rt_mesh, image, "gaussian", 2,
                                         **serve_kw["gaussian"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    spatial_keys = sorted(k for k in rt_mesh._warm if k[0] == "spatial")
    print(f"spatial serving launches: {spatial_launches} ({len(served)} calls, "
          f"keys {spatial_keys})")
    print(f"mesh batch launches: {mesh_batch_launches} ({len(mesh_batch)} calls "
          f"of 4 images over 4 blocks)")
    # Each call runs its timed reps, and the first call of a key one untimed
    # run more (gaussian L1/L2/L4 share a key, as do Sobel L1 and L4); a
    # timed run whose spin ran out runs again.  So each kernel moves by a
    # multiple of the 4 shards, at least 4 x the timed reps x its calls.
    spatial_calls = {"gaussian_planar": 3, "box_planar": 1, "sobel_planar": 1,
                     "sobel_f32_planar": 2}
    for name in KERNELS:
        n, calls_of = spatial_launches[name], spatial_calls.get(name, 0)
        require(n % 4 == 0 and n >= 4 * config.TIMING_REPS * calls_of
                and (n > 0) == (calls_of > 0),
                f"spatial serving launched {name} {n} times for {calls_of} calls")
    for name in ("gaussian_rows", "gaussian_band_rows", "box_rows", "sobel_rows",
                 "sobel_f32_rows"):
        require(mesh_batch_launches[name] >= 4 * config.TIMING_REPS,
                f"mesh batch launched {name} {mesh_batch_launches[name]} times")
    for name in PLANAR_KERNELS:
        require(mesh_batch_launches[name] == 0, f"mesh batch launched {name}")
    want_served = {("gaussian", 1): results[("gaussian", 2)]["image"],
                   ("gaussian", 2): results[("gaussian", 2)]["image"],
                   ("gaussian", 4): results[("gaussian", 2)]["image"],
                   ("box", 2): results[("box", 2)]["image"],
                   ("sobel", 1): results[("sobel", 1)]["image"],
                   ("sobel", 2): results[("sobel", 2)]["image"],
                   ("sobel", 4): sobel_l4}
    for key, (out, metrics) in served.items():
        require(np.array_equal(out, want_served[key]),
                f"spatial serving {key}: differs from single-device serving")
        require(metrics.time_ms > 0, f"spatial serving {key}: time_ms")
    for key, (out, metrics) in mesh_batch.items():
        require(np.array_equal(out, single_batch[key][0]),
                f"mesh batch {key}: differs from the one-device batch")
        require(metrics.fps > 0, f"mesh batch {key}: fps")
    # Each profile held every shard's launches (profiler.check_launches).
    for what, path, time_ms in (("batch", "batch(dp=4)", mesh_batch[("gaussian", 2)][1].time_ms),
                                ("spatial", "spatial(sp=4)", served[("gaussian", 2)][1].time_ms)):
        got_path = deep[what]["config"]["Serving Path"]
        names = deep[what]["kernels_profiled"]
        require(got_path == path, f"profiled {what} request: Serving Path {got_path}")
        require(any("gauss_window_rows<gip::Weighted" in k for k in names),
                f"profiled {what} request lists no gaussian kernel: {names}")
        require(deep[what]["total_kernel_duration_ms"] > 0, f"profiled {what}: no time")
        print(f"[{card}] profile gaussian L2 {path}: {deep[what]['total_kernel_duration_ms']:.4f} "
              f"ms a call (time_ms {time_ms:.4f}), sessions "
              f"{deep[what]['config']['Trace Sessions']}, primers kept "
              f"{deep[what]['config']['Trace Primers Kept']}, rows: " + ", ".join(
                  f"{short_kernel_name(k)} {v:.4f}"
                  for k, v in deep[what].get("kernel_durations_ms", {}).items()))
    print(f"serving on cuda:0 x 4 at {w}x{h}x{c}: spatial gaussian L1/L2/L4 == "
          f"single-device L2, box L2, sobel L1/L2/L4 == single-device; mesh "
          f"batch of 4 at L2 and L4 == the one-device batch")

    # Times: the runtime's time_ms of row-sharded serving beside the
    # single-device call's, and the sharded step's CUDA events at (1, 4)
    # beside the one-launch kernel's, with the halo bytes a boundary (r rows
    # each way: raw planes for the blurs, raw rows for Sobel).
    sp_mesh = meshes["(1, 4)"]
    img1 = batch4[:1]
    for f, radius, kernel_name in (("gaussian", MAIN_GAUSS_RADIUS, "gaussian_rows"),
                                   ("box", MAIN_BOX_RADIUS, "box_rows"),
                                   ("sobel", 3, "sobel_rows")):
        step = make_sharded_filter(sp_mesh, f, radius=radius)
        blocks = step.shard(torch.from_numpy(img1).to(dev))
        args = (table3,) if f == "gaussian" else ()
        step_ms = event_ms(lambda: step.step(blocks, *args))
        halo = spatial_halo(f, radius)
        print(f"[{card}] sharded {f} L2 {w}x{h}x{c} sp=4 on one card: time_ms "
              f"{served[(f, 2)][1].time_ms:.4f} (single-device "
              f"{results[(f, 2)]['time_ms']:.4f}), step events {step_ms:.4f} ms "
              f"(single-device kernel {times[kernel_name][0]:.4f} ms), halo "
              f"{2 * halo * w * c} bytes a boundary, 3 boundaries")
        # Where the step's time goes: the trace's device rows, ms a step.
        with traced([dev]) as prof:
            for _ in range(5):
                step.step(blocks, *args)
        rows_ms = sorted(((e.device_time_total / 1000.0 / 5, e.count / 5,
                           short_kernel_name(e.key)) for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.device_time_total > 0
                          and PRIMER_KERNEL not in e.key), reverse=True)
        print(f"[{card}] sharded {f} L2 step trace (ms a step, launches a step): "
              + "; ".join(f"{name} {ms:.4f} ({n:g})" for ms, n, name in rows_ms))
    for key, (out, metrics) in mesh_batch.items():
        print(f"[{card}] mesh batch {key[0]} L{key[1]} 4 x {w}x{h}x{c} dp=4 on one "
              f"card: time_ms {metrics.time_ms:.4f} (one-device batch "
              f"{single_batch[key][1].time_ms:.4f}), fps {metrics.fps:.1f}")
    dryrun_multichip(4, devices=cards4)
    print(f"multi-device phase: {time.perf_counter() - t8:.1f} s")
    del batch4, want4, single_batch, mesh_batch

    # -- 9. host entry points at full size ----------------------------------
    host_entry_points(rt, card, scene, scene_png, rng)

    # -- 10. the verification tier ------------------------------------------
    verification_tier(card)

    # -- 11. the installed package ------------------------------------------
    installed_package(card, scene_jpeg, jpeg_answer)
    print(f"executable cache at the end: {json.dumps(rt.executables.stats())}")
    print(f"total wall: {time.perf_counter() - t_start:.1f} s")

    # No single PyTorch call computes these functions (the u8 rounding
    # between the passes, clamp-to-edge and the Rec.601 grey rule), so
    # library_ms is null for every kernel.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"],
         "replaces": spec["replaces"], "also_replaces": spec["also_replaces"],
         "launches": (server_launches[name] + mesh_batch_launches[name]
                      if name in ROWS_KERNELS
                      else planes_launches[name] + spatial_launches[name]),
         "max_abs_err": max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, spec in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
