"""Batches in the port: (B, H, W*C) rows through every plain version and
`FilterRuntime.run_batch`, against the JAX package's batched kernels and
`run_batch` on the same seeded images.

The TPU kernels run in Pallas interpret mode, as the JAX tests run them on
the CPU.  Tolerances as in tests/test_torch_kernels.py and
tests/test_torch_level4.py: level-2 gaussian and box exact, the level-4
gaussian tiers within 1, Sobel `assert_sobel_close`.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.core.params import ValidationError as JaxValidationError
from gpu_image_processing_tpu.ops.pallas.blur import (
    box_pallas_rows_batch,
    gaussian_pallas_rows_batch,
)
from gpu_image_processing_tpu.ops.pallas.blur_mxu import (
    box_mxu_rows_batch,
    gaussian_mxu_rows_batch,
)
from gpu_image_processing_tpu.ops.pallas.sobel import sobel_pallas_rows_batch
from gpu_image_processing_tpu.ops.pallas.sobel_mxu import sobel_mxu_rows_batch
from gpu_image_processing_tpu.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu.runtime.dispatch import RUNTIME as JAX_RUNTIME
from gpu_image_processing_tpu_torch.core.params import ValidationError
from gpu_image_processing_tpu_torch.ops import interleaved
from gpu_image_processing_tpu_torch.ops.cuda import blur, sobel
from gpu_image_processing_tpu_torch.ops.weights import bf16_split, weights_to_torch
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

from .sobel_tolerance import assert_sobel_close

SHAPES = [(3, 13, 17, 3), (2, 11, 9, 1), (3, 9, 14, 4)]
CPU = torch.device("cpu")


def _stack(rng, b, h, w, c):
    return rng.integers(0, 256, size=(b, h, w, c), dtype=np.uint8)


def _port(fn, imgs, *args):
    b, h, w, c = imgs.shape
    rows = torch.from_numpy(imgs.reshape(b, h, w * c).copy())
    return fn(rows, *args).numpy().reshape(b, h, w, c)


def _tpu(fn, imgs, *args):
    b, h, w, c = imgs.shape
    return np.asarray(jax.jit(fn)(imgs.reshape(b, h, w * c), *args)).reshape(
        b, h, w, c)


def _plain_fns(radius, sigma, width, channels):
    """name -> plain function of rows: every kernel's plain version."""
    table = gaussian_kernel_f32(radius, sigma)
    w = weights_to_torch(table, CPU)
    hi, lo = (weights_to_torch(t, CPU) for t in bf16_split(table))
    r, c = radius, channels
    return {
        "gaussian": lambda x: blur.gaussian_rows_plain(x, w, r, c),
        "folded": lambda x: blur.gaussian_folded_rows_plain(x, w, r, c),
        "band": lambda x: blur.gaussian_band_rows_plain(x, hi, lo, r, c),
        "box": lambda x: blur.box_rows_plain(x, r, c),
        "sobel": lambda x: sobel.sobel_rows_plain(x, width, c),
        "sobel_f32": lambda x: sobel.sobel_f32_rows_plain(x, width, c),
    }


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 3])
def test_batched_plain_equals_each_image(rng, shape, radius):
    # Each image clamps at its own first and last row: a batch is never
    # blurred across images.
    imgs = _stack(rng, *shape)
    b, h, w, c = shape
    for name, fn in _plain_fns(radius, 2.0, w, c).items():
        batched = _port(fn, imgs)
        for i in range(b):
            np.testing.assert_array_equal(
                batched[i], _port(fn, imgs[i:i + 1])[0], err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_gaussian_matches_tpu_batch_kernels(rng, shape):
    imgs = _stack(rng, *shape)
    c = shape[3]
    fns = _plain_fns(2, 1.5, shape[2], c)
    w2 = gaussian_kernel_f32(2, 1.5)
    want = _tpu(lambda r, ww: gaussian_pallas_rows_batch(
        r, ww, 2, c, interpret=True), imgs, w2)
    np.testing.assert_array_equal(_port(fns["gaussian"], imgs), want)
    want = _tpu(lambda r, ww: gaussian_pallas_rows_batch(
        r, ww, 2, c, interpret=True, folded=True), imgs, w2)
    assert np.abs(_port(fns["folded"], imgs).astype(int) - want).max() <= 1
    w4 = gaussian_kernel_f32(4, 2.0)
    want = _tpu(lambda r, ww: gaussian_mxu_rows_batch(
        r, ww, 4, c, interpret=True), imgs, w4)
    got = _port(_plain_fns(4, 2.0, shape[2], c)["band"], imgs)
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("shape", SHAPES)
def test_batched_box_matches_tpu_batch_kernels(rng, shape):
    imgs = _stack(rng, *shape)
    c = shape[3]
    got = _port(lambda x: blur.box_rows_plain(x, 1, c), imgs)
    want = _tpu(lambda r: box_pallas_rows_batch(r, 1, c, interpret=True), imgs)
    np.testing.assert_array_equal(got, want)
    got = _port(lambda x: blur.box_rows_plain(x, 4, c), imgs)
    want = _tpu(lambda r: box_mxu_rows_batch(r, 4, c, interpret=True), imgs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2])
def test_batched_sobel_matches_tpu_batch_kernels(rng, shape, level):
    imgs = _stack(rng, *shape)
    b, h, w, c = shape
    fn = sobel.sobel_f32_rows_plain if level == 1 else sobel.sobel_rows_plain
    got = _port(lambda x: fn(x, w, c), imgs)
    want = _tpu(lambda r: sobel_pallas_rows_batch(r, w, c, level=level,
                                                  interpret=True), imgs)
    for i in range(b):
        assert_sobel_close(got[i], want[i])
    if c > 1:
        want = _tpu(lambda r: sobel_mxu_rows_batch(r, w, c, level=level,
                                                   interpret=True), imgs)
        for i in range(b):
            assert_sobel_close(got[i], want[i])


def test_interleaved_sobel_takes_a_batch(rng):
    imgs = _stack(rng, 2, 7, 6, 3)
    got = _port(lambda x: interleaved.sobel_rows(x, 2, 6, 3), imgs)
    assert got.shape == imgs.shape
    assert not got[:, 0].any() and not got[:, -1].any()
    assert not got[:, :, 0].any() and not got[:, :, -1].any()


@pytest.mark.parametrize("name,kwargs", [
    ("gaussian", {"sigma": 2.0, "radius": 2}),
    ("gaussian", {"sigma": 2.0, "radius": 4}),
    ("box", {"radius": 3}),
    ("sobel", {}),
])
@pytest.mark.parametrize("level", [1, 2, 4])
def test_run_batch_matches_jax(rng, name, kwargs, level):
    imgs = _stack(rng, 3, 12, 15, 3)
    keep = imgs.copy()
    got, metrics = FilterRuntime("cpu").run_batch(name, imgs, level=level, **kwargs)
    want, _ = JAX_RUNTIME.run_batch(name, imgs, level=level, **kwargs)
    assert got.shape == want.shape == imgs.shape and got.dtype == np.uint8
    if name == "sobel":
        for i in range(3):
            assert_sobel_close(got[i], want[i])
    elif name == "gaussian" and level == 4:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imgs, keep)
    # Whole-batch metrics, fps in images per second.
    factor = 2 if name == "sobel" else 4
    gbps = 12 * 15 * 3 * 3 * factor / (metrics.time_ms / 1000.0) / 1024.0**3
    assert metrics.bandwidth_gbps == pytest.approx(gbps)
    assert metrics.fps == pytest.approx(3 * 1000.0 / metrics.time_ms)


@pytest.mark.parametrize("level", [1, 2, 4])
def test_run_batch_equals_single_runs(rng, level):
    imgs = _stack(rng, 3, 10, 11, 4)
    rt = FilterRuntime("cpu")
    for name, kwargs in [("gaussian", {"radius": 3}), ("box", {"radius": 2}),
                         ("sobel", {})]:
        out, _ = rt.run_batch(name, imgs, level=level, **kwargs)
        for i in range(3):
            np.testing.assert_array_equal(
                out[i], rt.run(name, imgs[i], level=level, **kwargs)[0])


@pytest.mark.parametrize("call", [
    lambda rt, rng: rt.run_batch("box", _stack(rng, 1, 8, 8, 3)[0]),
    lambda rt, rng: rt.run_batch("box", np.zeros((0, 8, 8, 3), np.uint8)),
    lambda rt, rng: rt.run_batch("box", np.zeros((2, 8, 8, 2), np.uint8)),
    lambda rt, rng: rt.run_batch("median", _stack(rng, 2, 8, 8, 3)),
    lambda rt, rng: rt.run_batch("sobel", _stack(rng, 2, 8, 8, 3), level=5),
    lambda rt, rng: rt.run_batch("gaussian", _stack(rng, 2, 8, 8, 3), radius=40),
])
def test_run_batch_validates_as_jax(rng, call):
    with pytest.raises(ValidationError) as got:
        call(FilterRuntime("cpu"), rng)
    with pytest.raises(JaxValidationError) as want:
        call(JAX_RUNTIME, rng)
    assert str(got.value) == str(want.value)


@pytest.mark.cuda
def test_batched_launches_equal_single_launches_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    dev = torch.device("cuda")
    for b, h, w, c in SHAPES:
        rows = torch.from_numpy(
            _stack(rng, b, h, w, c).reshape(b, h, w * c)).to(dev)
        for radius in (2, 3):
            table = gaussian_kernel_f32(radius, 2.0)
            wt = weights_to_torch(table, dev)
            hi, lo = (weights_to_torch(t, dev) for t in bf16_split(table))
            kernels = [
                lambda x: blur.gaussian_rows(x, wt, radius, c),
                lambda x: blur.gaussian_folded_rows(x, wt, radius, c),
                lambda x: blur.gaussian_band_rows(x, hi, lo, radius, c),
                lambda x: blur.box_rows(x, radius, c),
                lambda x: sobel.sobel_rows(x, w, c),
                lambda x: sobel.sobel_f32_rows(x, w, c),
            ]
            for kernel in kernels:
                out = kernel(rows)
                for i in range(b):
                    assert torch.equal(out[i], kernel(rows[i].contiguous()))


@pytest.mark.parametrize("batch,ok", [(1, True), (blur.MAX_BATCH, True),
                                      (0, False), (blur.MAX_BATCH + 1, False)])
def test_launch_rows_take_one_to_max_batch_images(batch, ok):
    rows = torch.zeros((batch, 2, 6), dtype=torch.uint8)
    if ok:
        assert blur.check_rows(rows, 3) == (batch, 2, 2)
    else:
        with pytest.raises(ValueError, match="batch of"):
            blur.check_rows(rows, 3)
