"""Level-1 torch ops of the port against the JAX package and the numpy oracle.

Same inputs (numpy, seeded) go through `gpu_image_processing_tpu.ops` (JAX on
the CPU) and `gpu_image_processing_tpu_torch.ops` (torch on the CPU).

Tolerances: gaussian and box are bit-exact at the suite's fixed sigmas.  At a
random sigma XLA may contract a multiply-add into one FMA and flip a
floor(x + 0.5) tie (the JAX package's own random-sigma gate is <= 1,
scripts/soak_fuzz.py), so the port is held to maxdiff <= 1
against JAX there and stays exact against the numpy oracle, which rounds
every operation as the port does.  Grey Sobel is exact; colour Sobel against
JAX uses `assert_sobel_close` for the same FMA reason.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops import interleaved as jax_il
from gpu_image_processing_tpu.ops import rounding as jax_rounding
from gpu_image_processing_tpu.ops import weights as jax_weights
from gpu_image_processing_tpu_torch.ops import interleaved as il
from gpu_image_processing_tpu_torch.ops import rounding
from gpu_image_processing_tpu_torch.ops.weights import (
    gaussian_kernel_f32,
    weights_to_torch,
)

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close

SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4)]
CPU = torch.device("cpu")


def _rows(img):
    h, w, c = img.shape
    return img.reshape(h, w * c)


def _port(fn, img, *args):
    h, w, c = img.shape
    out = fn(torch.from_numpy(_rows(img).copy()), *args)
    return out.numpy().reshape(h, w, c)


def _jax(fn, img, *args):
    h, w, c = img.shape
    return np.asarray(jax.jit(fn)(_rows(img), *args)).reshape(h, w, c)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (3, 2.0), (5, 2.5), (8, 4.0)])
def test_gaussian_rows_exact(rng, shape, radius, sigma):
    img = make_image(rng, *shape)
    c = shape[2]
    w = jax_weights.gaussian_kernel_f32(radius, sigma)
    got = _port(il.gaussian_rows, img, weights_to_torch(w, CPU), radius, c)
    want = _jax(lambda r, ww: jax_il.gaussian_rows(r, ww, radius, c), img, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.gaussian_blur(img, w, radius))


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_rows_random_sigma(rng, shape):
    img = make_image(rng, *shape)
    c = shape[2]
    radius = int(rng.integers(1, 16))
    sigma = float(rng.uniform(0.5, 20.0))
    w = jax_weights.gaussian_kernel_f32(radius, sigma)
    got = _port(il.gaussian_rows, img, weights_to_torch(w, CPU), radius, c)
    want = _jax(lambda r, ww: jax_il.gaussian_rows(r, ww, radius, c), img, w)
    assert np.abs(got.astype(int) - want).max() <= 1
    np.testing.assert_array_equal(got, oracle.gaussian_blur(img, w, radius))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 2, 5, 25])
def test_box_rows_exact(rng, shape, radius):
    # r=25 exceeds every image height: the clamp covers it.
    img = make_image(rng, *shape)
    c = shape[2]
    got = _port(il.box_rows, img, radius, c)
    want = _jax(lambda r: jax_il.box_rows(r, radius, c), img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.box_blur(img, radius))


@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 3), (1, 7, 1), (5, 2, 4)])
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_rows(rng, shape, level):
    img = make_image(rng, *shape)
    h, w, c = shape
    got = _port(il.sobel_rows, img, level, w, c)
    want = _jax(lambda r: jax_il.sobel_rows(r, level, w, c), img)
    assert_sobel_close(got, want)
    np.testing.assert_array_equal(got, oracle.sobel(img, level))
    if min(h, w) < 3:
        assert not got.any()   # thinner than 3 px: all border


def test_sobel_writes_alpha(rng):
    img = make_image(rng, 9, 11, 4)
    got = _port(il.sobel_rows, img, 2, 11, 4)
    for ch in range(1, 4):
        np.testing.assert_array_equal(got[..., ch], got[..., 0])


def test_quantize_rounds_half_up():
    x = np.array([0.5, 1.5, 2.5, 254.5, 255.7, -0.2, 3.49999], np.float32)
    got = rounding.quantize_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_rounding.quantize_u8(x)))
    np.testing.assert_array_equal(got, [1, 2, 3, 255, 255, 0, 3])


@pytest.mark.parametrize("radius,sigma", [(1, 0.5), (3, 2.0), (15, 8.0), (31, 19.7)])
def test_weights_match_jax_bits(radius, sigma):
    want = jax_weights.gaussian_kernel_f32(radius, sigma)
    got = gaussian_kernel_f32(radius, sigma)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    t = weights_to_torch(want, CPU)
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("bad", [np.ones(4, np.float32), np.ones(3, np.float64),
                                 np.ones((3, 1), np.float32)])
def test_weights_to_torch_rejects_bad_tables(bad):
    with pytest.raises(ValueError):
        weights_to_torch(bad, CPU)
