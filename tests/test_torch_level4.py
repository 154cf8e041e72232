"""Level 4 of the port: the folded and band gaussian and the f32-grey Sobel.

Each plain version (what the kernel computes, in plain torch ops) against
the TPU kernel it replaces, run as the JAX package's own tests run it on the
CPU: in Pallas interpret mode.  Tolerances: folded gaussian 0 expected, <=1
allowed (the same symmetric pairs in the same order, but XLA may regroup);
band gaussian <=1 (the TPU sums each band matmul in its own order; the port
sums in tap order); Sobel `assert_sobel_close` (exact for grey images).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops.pallas.blur import gaussian_pallas_rows
from gpu_image_processing_tpu.ops.pallas.blur_mxu import gaussian_mxu_rows
from gpu_image_processing_tpu.ops.pallas.sobel import sobel_pallas_rows
from gpu_image_processing_tpu.ops.pallas.sobel_mxu import sobel_mxu_rows
from gpu_image_processing_tpu.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES, blur, sobel
from gpu_image_processing_tpu_torch.ops.weights import bf16_split, weights_to_torch
from gpu_image_processing_tpu_torch.runtime.dispatch import (
    GAUSS_MXU_MIN_RADIUS,
    FilterRuntime,
)

from .conftest import make_image
from .sobel_tolerance import assert_sobel_close

SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4)]
CPU = torch.device("cpu")


def _rows(img):
    h, w, c = img.shape
    return img.reshape(h, w * c)


def _port(fn, img, *args):
    h, w, c = img.shape
    return fn(torch.from_numpy(_rows(img).copy()), *args).numpy().reshape(h, w, c)


def _tpu(fn, img, *args):
    h, w, c = img.shape
    return np.asarray(jax.jit(fn)(_rows(img), *args)).reshape(h, w, c)


def _maxdiff(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _tables(radius, sigma):
    w = gaussian_kernel_f32(radius, sigma)
    hi, lo = (weights_to_torch(t, CPU) for t in bf16_split(w))
    return w, weights_to_torch(w, CPU), hi, lo


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (2, 1.5), (3, 2.0)])
def test_folded_plain_matches_blur_kernel(rng, shape, radius, sigma):
    img = make_image(rng, *shape)
    c = shape[2]
    w, wt, _, _ = _tables(radius, sigma)
    got = _port(blur.gaussian_folded_rows_plain, img, wt, radius, c)
    want = _tpu(lambda r, ww: gaussian_pallas_rows(
        r, ww, radius, c, interpret=True, folded=True), img, w)
    assert _maxdiff(got, want) <= 1
    # Within 1 of level 2, and the wrapper serves the plain version on CPU.
    assert _maxdiff(got, _port(blur.gaussian_rows_plain, img, wt, radius, c)) <= 1
    np.testing.assert_array_equal(
        _port(blur.gaussian_folded_rows, img, wt, radius, c), got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(3, 2.0), (5, 2.5), (8, 4.0)])
def test_band_plain_matches_mxu_kernel(rng, shape, radius, sigma):
    img = make_image(rng, *shape)
    c = shape[2]
    w, wt, hi, lo = _tables(radius, sigma)
    got = _port(blur.gaussian_band_rows_plain, img, hi, lo, radius, c)
    want = _tpu(lambda r, ww: gaussian_mxu_rows(r, ww, radius, c,
                                                interpret=True), img, w)
    assert _maxdiff(got, want) <= 1
    assert _maxdiff(got, _port(blur.gaussian_rows_plain, img, wt, radius, c)) <= 1
    np.testing.assert_array_equal(
        _port(blur.gaussian_band_rows, img, hi, lo, radius, c), got)


@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (3, 2.0), (15, 8.0), (31, 8.0)])
def test_bf16_split_matches_the_tpu_split(radius, sigma):
    # hi = bf16(w) rounded to nearest even, lo = bf16(w - hi)
    # (blur_mxu.py:180-186, which uses reduce_precision for the same value).
    w = gaussian_kernel_f32(radius, sigma)
    hi, lo = bf16_split(w)
    want_hi = np.asarray(jax.lax.reduce_precision(jnp.asarray(w), 8, 7))
    want_lo = np.asarray((jnp.asarray(w) - want_hi).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)
    assert hi.dtype == lo.dtype == np.float32
    # Exact bf16 values: the low 16 bits of each float are zero.
    assert not (hi.view(np.uint32) & 0xFFFF).any()
    assert not (lo.view(np.uint32) & 0xFFFF).any()
    np.testing.assert_allclose(hi + lo, w, rtol=2**-15)


@pytest.mark.parametrize("shape", SHAPES)
def test_sobel_f32_plain_matches_sobel_kernel(rng, shape):
    img = make_image(rng, *shape)
    h, w, c = shape
    got = _port(sobel.sobel_f32_rows_plain, img, w, c)
    want = _tpu(lambda r: sobel_pallas_rows(r, w, c, level=1, interpret=True),
                img)
    if c == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert_sobel_close(got, want)
    np.testing.assert_array_equal(_port(sobel.sobel_f32_rows, img, w, c), got)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] > 1])
def test_sobel_f32_plain_matches_mxu_kernel(rng, shape):
    img = make_image(rng, *shape)
    h, w, c = shape
    got = _port(sobel.sobel_f32_rows_plain, img, w, c)
    want = _tpu(lambda r: sobel_mxu_rows(r, w, c, level=1, interpret=True), img)
    assert_sobel_close(got, want)


@pytest.mark.parametrize("radius", [1, 2, 3, 7])
def test_level4_gaussian_routes_on_radius(rng, radius):
    # Folded taps below GAUSS_MXU_MIN_RADIUS, the band from it up: the same
    # split as the JAX package's use_mxu_gaussian.
    img = make_image(rng, 16, 18, 3)
    _, wt, hi, lo = _tables(radius, 2.0)
    got, _ = FilterRuntime("cpu").run("gaussian", img, level=4, sigma=2.0,
                                      radius=radius)
    if radius < GAUSS_MXU_MIN_RADIUS:
        want = _port(blur.gaussian_folded_rows_plain, img, wt, radius, 3)
    else:
        want = _port(blur.gaussian_band_rows_plain, img, hi, lo, radius, 3)
    np.testing.assert_array_equal(got, want)


def test_level4_box_and_sobel_route_to_their_kernels(rng):
    img = make_image(rng, 16, 18, 3)
    rt = FilterRuntime("cpu")
    np.testing.assert_array_equal(rt.run("box", img, level=4, radius=5)[0],
                                  rt.run("box", img, level=2, radius=5)[0])
    np.testing.assert_array_equal(rt.run("sobel", img, level=4)[0],
                                  _port(sobel.sobel_f32_rows_plain, img, 18, 3))
    np.testing.assert_array_equal(rt.run("sobel", img, level=4)[0],
                                  rt.run("sobel", img, level=1)[0])


def test_cpu_level4_calls_launch_nothing(rng):
    img = make_image(rng, 8, 9, 3)
    _, wt, hi, lo = _tables(3, 2.0)
    before = dict(LAUNCHES)
    _port(blur.gaussian_folded_rows, img, wt, 3, 3)
    _port(blur.gaussian_band_rows, img, hi, lo, 3, 3)
    _port(sobel.sobel_f32_rows, img, 9, 3)
    assert dict(LAUNCHES) == before


def test_level4_wrappers_never_serve_plain_off_the_cpu():
    rows = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    w = torch.empty(7, dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="cuda device"):
        blur.gaussian_folded_rows(rows, w, 3, 3)
    with pytest.raises(RuntimeError, match="cuda device"):
        blur.gaussian_band_rows(rows, w, w, 3, 3)
    with pytest.raises(RuntimeError, match="cuda device"):
        sobel.sobel_f32_rows(rows, 4, 3)
    with pytest.raises(ValueError, match="lo"):
        blur.gaussian_band_rows(rows, w, w[:5], 3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 3), (1, 7, 1)])
def test_level4_kernels_match_plain_on_card(rng, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    dev = torch.device("cuda")
    img = make_image(rng, *shape)
    h, w, c = shape
    rows = torch.from_numpy(_rows(img).copy()).to(dev)
    for radius, sigma in [(1, 1.0), (2, 1.5), (3, 2.0), (15, 8.0), (31, 8.0)]:
        table = gaussian_kernel_f32(radius, sigma)
        wt = weights_to_torch(table, dev)
        hi, lo = (weights_to_torch(t, dev) for t in bf16_split(table))
        assert torch.equal(blur.gaussian_folded_rows(rows, wt, radius, c),
                           blur.gaussian_folded_rows_plain(rows, wt, radius, c))
        # The band sums on the tensor cores, not in tap order: maxdiff <= 1
        # on at most 0.1% of bytes, and the same bits on every launch.
        band = blur.gaussian_band_rows(rows, hi, lo, radius, c)
        diff = (band.to(torch.int32) - blur.gaussian_band_rows_plain(
            rows, hi, lo, radius, c).to(torch.int32)).abs()
        assert int(diff.max()) <= blur.BAND_MAX_DIFF
        assert float((diff > 0).float().mean()) <= blur.BAND_MAX_FRACTION
        assert torch.equal(band, blur.gaussian_band_rows(rows, hi, lo, radius, c))
    got = sobel.sobel_f32_rows(rows, w, c).cpu().numpy().reshape(h, w, c)
    want = sobel.sobel_f32_rows_plain(rows, w, c).cpu().numpy().reshape(h, w, c)
    assert_sobel_close(got, want)
