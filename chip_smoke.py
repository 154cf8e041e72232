#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each of which fails the run on its own:

1. device: CUDA present, compute capability 9.0; prints the card, its power
   limit and the toolchain;
2. build: builds every library of the main path from the sources, one
   compiler a library, all started together: nvcc for the kernels and the
   PNG unfilter helper, the host C++ compiler for the upload decoders of
   native/src;
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
   the PNG codec's C++ unfilter helper against its numpy version; the
   upload decoders on the committed fixtures (tests/data/torch_formats:
   JPEG 4:2:0, 4:4:4 and grey, GIF, BMP, PSD, HDR, PIC, PNM, TGA and 1-,
   4-, 16-bit and interlaced PNG) against the pixels the JAX package
   decoded from them, exactly; and the level-2 API on a small image against
   the numpy oracle;
4. API path: the `gpu_filters` API and `run_all_levels` on the full image
   through FilterRuntime(cuda), with its kernels' launch counts read around
   that run; then a torch.profiler trace of the model's forward, which must
   list the rows kernel alone, and a Chrome trace of one API call
   (`capture_trace`), which must show the gaussian kernel (both before the
   server's profiled requests, after which traces kept only some of the
   hand kernels' launches);
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
   decode, run, encode and profile; then the codec's split (base64,
   inflate, unfilter, CRC, JPEG decode, the whole PNG encode and its
   deflate) on the scene's PNG and JPEG;
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
   single-device ones, with the halo bytes; `dryrun_multichip(4)`.

The line before the last is a JSON object `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`.  Any failure exits non-zero and prints no ok
line, as does a host without CUDA or a directory without the package.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from torch import nn

from gpu_image_processing_tpu_torch.api import filters as api
from gpu_image_processing_tpu_torch.core import config
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
    PEAKS, capture_trace, profile_batch, profile_filter, short_kernel_name)
from gpu_image_processing_tpu_torch.runtime.device import describe
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.server.app import create_app
from gpu_image_processing_tpu_torch.server.http import AppServer
from gpu_image_processing_tpu_torch.utils import native_codec
from gpu_image_processing_tpu_torch.utils.image import (
    decode_base64_image, decode_png, encode_png, host_unfilter, unfilter_native,
    unfilter_plain)
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
HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_TENSOR_OPS_PER_S = PEAKS["NVIDIA H100 80GB HBM3"]
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
        "profiler_names": ["gauss_window_rows<gip::Weighted"],
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
        "profiler_names": ["gauss_window_rows<gip::Weighted"],
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
    (..., H, W, C) uint8: each input byte read once and each output byte
    written once, against the operations the function needs, at the peaks
    above.  Operations per output element of each pass, 2r+1 taps:
    weighted 2(2r+1) (a multiply and an add per tap); folded 3r+2 (r pair
    sums, r+1 multiplies, r+1 adds); band 4(2r+1)+1 (two products and two
    sums per tap, then hi + lo); box 4 at any radius (a running window sum
    adds the incoming tap and subtracts the outgoing one, then the scale
    and the rounding add, counted at the f32 rate), since the window sum is
    exact in any order and needs no more.  Sobel per pixel: 5 for the grey value, 11 each
    for gx and gy, 8 for the magnitude and rounding.  All at the float32
    rate of one instruction an operation (F32_OPS_PER_S), except the band: its products are u8 pixels times bf16 weights,
    exact in bf16, summed in f32, the band matmul that the TPU ran on its
    matrix unit, which the card runs on its tensor cores."""
    elems = int(np.prod(shape))
    pixels = elems // shape[-1]
    taps = 2 * radius + 1
    per_pass = {"gaussian_rows": 2 * taps, "gaussian_folded_rows": 3 * radius + 2,
                "gaussian_band_rows": 4 * taps + 1, "box_rows": 4,
                "gaussian_planar": 2 * taps, "gaussian_folded_planar": 3 * radius + 2,
                "box_planar": 4}
    ops = (2 * per_pass[name] * elems if name in per_pass
           else (5 + 11 + 11 + 8) * pixels)
    rate = BF16_TENSOR_OPS_PER_S if name == "gaussian_band_rows" else F32_OPS_PER_S
    bytes_ms = 2 * elems / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


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


def client_png(img: np.ndarray) -> tuple[bytes, dict[int, int]]:
    """(PNG bytes, rows per filter type) of an (H, W, 3) image as libpng and
    Pillow write it by default: each row's filter (None, Sub, Up, Average or
    Paeth) chosen by the least sum of absolute signed residuals, the PNG
    specification's heuristic, then zlib level 6."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, c:] = x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    lines = np.empty((h, w * c + 1), np.uint8)
    best = None
    for kind, pred in enumerate((0, a, b, (a + b) >> 1, paeth)):
        res = ((x - pred) & 0xFF).astype(np.uint8)
        cost = np.abs(res.view(np.int8).astype(np.int32)).sum(axis=1)
        take = np.ones(h, bool) if best is None else cost < best
        best = cost if best is None else np.where(take, cost, best)
        lines[take, 0] = kind
        lines[take, 1:] = res[take]

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(lines.tobytes(), 6)) + chunk(b"IEND", b""))
    kinds, counts = np.unique(lines[:, 0], return_counts=True)
    return png, dict(zip(kinds.tolist(), counts.tolist()))


def best_ms(fn, reps: int = 3) -> float:
    """Least host-clock ms of `reps` calls of `fn`."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1000.0)
    return best


def idat(png: bytes) -> bytes:
    """The concatenated IDAT payloads of a PNG."""
    parts, pos = [], 8
    while pos + 8 <= len(png):
        length, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if kind == b"IDAT":
            parts.append(png[pos + 8:pos + 8 + length])
        pos += 12 + length
    return b"".join(parts)


def codec_split(png: bytes, jpeg: bytes, answer: np.ndarray) -> dict[str, float]:
    """Host-clock ms (least of 3) of each step of the server's codec: the
    two uploads' decodes (base64, then inflate and unfilter for the PNG, the
    native decoder for the JPEG) and the PNG encode of an answer (filter
    and CRCs, deflate at level 1, base64)."""
    h, w, c = answer.shape
    png_text, jpeg_text = (base64.b64encode(x) for x in (png, jpeg))
    raw = np.frombuffer(zlib.decompress(idat(png)), np.uint8)
    out = encode_png(answer)
    lines = zlib.decompress(idat(out))
    unfilter = host_unfilter()
    steps = {
        "PNG upload: base64 decode": best_ms(lambda: base64.b64decode(png_text)),
        "PNG upload: inflate": best_ms(lambda: zlib.decompress(idat(png))),
        "PNG upload: unfilter": best_ms(lambda: unfilter(raw, h, w * c, c)),
        "PNG upload: CRC of the image data": best_ms(lambda: zlib.crc32(idat(png))),
        "PNG upload: decode_png in all": best_ms(lambda: decode_png(png)),
        "JPEG upload: base64 decode": best_ms(lambda: base64.b64decode(jpeg_text)),
        "JPEG upload: native JPEG decode": best_ms(
            lambda: native_codec.jpeg_decode(jpeg)),
        "PNG answer: encode_png in all": best_ms(lambda: encode_png(answer)),
        "PNG answer: deflate": best_ms(lambda: zlib.compress(lines, 1)),
        "PNG answer: base64 encode": best_ms(lambda: base64.b64encode(out)),
    }
    return steps


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
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(build.LIBRARIES)} (one compiler each, in parallel: "
          f"nvcc for the kernels and the unfilter helper, the host C++ "
          f"compiler for the decoders); each: " + ", ".join(
              f"{n} {t:.1f} s" for n, t in build.BUILD_SECONDS.items()))
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

    # The PNG codec's C++ unfilter helper against its numpy plain version,
    # every filter type in turn, 1 to 4 bytes a pixel.
    for bpp in (1, 2, 3, 4):
        height, row_bytes = 40, 97 * bpp
        raw = rng.integers(0, 256, size=(height, row_bytes + 1), dtype=np.uint8)
        raw[:, 0] = np.arange(height) % 5
        require(np.array_equal(
            unfilter_native(raw.reshape(-1), height, row_bytes, bpp),
            unfilter_plain(raw.reshape(-1), height, row_bytes, bpp)),
            f"png unfilter helper differs from its plain version at bpp {bpp}")
    require(host_unfilter() is unfilter_native,
            "the codec does not decode with the C++ unfilter helper here")
    print("png unfilter helper == plain for filter types 0-4, bpp 1-4; the "
          "codec decodes with the helper")

    # The upload decoders (JPEG and the native formats through the library
    # of native/src, PNG through the port's codec) on the committed
    # fixtures, against the pixels the JAX package decoded from them (its
    # native tier for JPEG): any difference fails.
    cxx_version = subprocess.run([build.cxx_path(), "--version"], capture_output=True,
                                 text=True, check=True).stdout.splitlines()[0]
    print(f"decoder library: built from {', '.join(p.name for p in build.DECODER_SOURCES)} "
          f"by {cxx_version} in {build.BUILD_SECONDS.get(build.DECODERS, 0.0):.1f} s "
          f"(phase 2, beside nvcc)")
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
    # copy of its table.  Traced here, before the server's profiled
    # requests: later in the process torch.profiler's traces kept only some
    # of the hand kernels' launches (PERF.md, open questions).  Then a
    # Chrome trace of one API call (`capture_trace`).
    image_t = torch.from_numpy(image).to(dev)
    model = GaussianBlur(MAIN_SIGMA, MAIN_GAUSS_RADIUS, 2).to(dev)
    model(image_t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(image_t)
        torch.cuda.synchronize()
    forward_kernels = sorted({e.key for e in prof.key_averages()
                              if getattr(e, "device_time_total", 0) > 0})
    print(f"profiler: GaussianBlur(level=2) forward -> {forward_kernels}")
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
              f"ncu_profiled_time_ms {m['ncu_profiled_time_ms']:.4f}, DRAM "
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
    # The codec's split on the scene's uploads and its PNG answer.
    split = codec_split(scene_png, scene_jpeg, served[("gaussian", 2)])
    print(f"[{card}] codec split at {w}x{h} (host clock, ms, least of 3): "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        torch.cuda.synchronize()
    device_kernels = [e.key for e in prof.key_averages()
                      if getattr(e, "device_time_total", 0) > 0]
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
    # The trace need not list every shard's launch (late in a process
    # traces drop some hand-kernel launches, PERF.md): the kernel's name and
    # a profiled time are required.
    for what, path, time_ms in (("batch", "batch(dp=4)", mesh_batch[("gaussian", 2)][1].time_ms),
                                ("spatial", "spatial(sp=4)", served[("gaussian", 2)][1].time_ms)):
        got_path = deep[what]["config"]["Serving Path"]
        names = deep[what]["kernels_profiled"]
        require(got_path == path, f"profiled {what} request: Serving Path {got_path}")
        require(any("gauss_window_rows<gip::Weighted" in k for k in names),
                f"profiled {what} request lists no gaussian kernel: {names}")
        require(deep[what]["total_kernel_duration_ms"] > 0, f"profiled {what}: no time")
        print(f"[{card}] profile gaussian L2 {path}: {deep[what]['total_kernel_duration_ms']:.4f} "
              f"ms a call (time_ms {time_ms:.4f}), rows: " + ", ".join(
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step.step(blocks, *args)
            torch.cuda.synchronize()
        rows_ms = sorted(((e.device_time_total / 1000.0 / 5, e.count / 5,
                           short_kernel_name(e.key)) for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.device_time_total > 0), reverse=True)
        print(f"[{card}] sharded {f} L2 step trace (ms a step, launches a step): "
              + "; ".join(f"{name} {ms:.4f} ({n:g})" for ms, n, name in rows_ms))
    for key, (out, metrics) in mesh_batch.items():
        print(f"[{card}] mesh batch {key[0]} L{key[1]} 4 x {w}x{h}x{c} dp=4 on one "
              f"card: time_ms {metrics.time_ms:.4f} (one-device batch "
              f"{single_batch[key][1].time_ms:.4f}), fps {metrics.fps:.1f}")
    dryrun_multichip(4, devices=cards4)
    print(f"multi-device phase: {time.perf_counter() - t8:.1f} s")
    del batch4, want4, single_batch, mesh_batch
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
