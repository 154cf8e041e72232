"""The arguments the redesigned blur kernels rest on, checked on the CPU.

`box_window_rows` and `box_wide_h`/`_v` (ops/cuda/blur.cu) compute the box
with running window sums instead of tap loops; `band_mma_rows` computes the
level-4 band as banded bf16 matrix products on the tensor cores.  Neither
runs here, so each gets a model of its order of operations:

* a numpy running-sum box: int64 cumulative sums over the clamped indices,
  then the f32 scale and floor(x + 0.5), which must equal the plain version
  (`blur.box_rows_plain`) and the JAX package's box bit for bit: integer
  window sums are exact in any order;
* a torch tensor-core band: the banded matrix product of the kernel's tile
  geometry (16 output lanes, depth 16 + 2rC rounded up to 16, taps C lanes
  apart on rows; 16 rows and depth 16 + 2r vertically), summed in f32 in
  k-chunks of 16, an order other than tap order.  It must hold the stated
  tolerance, maxdiff <= 1 on at most 0.1% of bytes (`blur.BAND_MAX_DIFF`,
  `blur.BAND_MAX_FRACTION`), against the tap-order plain version and the
  JAX band kernel (Pallas interpret mode).
"""

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops.pallas.blur_mxu import (
    box_mxu_rows,
    box_mxu_rows_batch,
    gaussian_mxu_rows,
    gaussian_mxu_rows_batch,
)
from gpu_image_processing_tpu.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu_torch.ops import interleaved
from gpu_image_processing_tpu_torch.ops.cuda import blur
from gpu_image_processing_tpu_torch.ops.weights import (
    bf16_split,
    box_inv_taps_f32,
    weights_to_torch,
)

CPU = torch.device("cpu")


def _running_box_pass(x: np.ndarray, radius: int, axis: int) -> np.ndarray:
    """One box pass of the running-sum kernels along `axis` of an int64
    array: window sums over clamped indices from an int64 cumulative sum,
    then floor(f32(sum) * f32(1/taps) + 0.5) clamped to [0, 255]."""
    n = x.shape[axis]
    taps = 2 * radius + 1
    padded = np.take(x, np.clip(np.arange(-radius, n + radius), 0, n - 1),
                     axis=axis)
    zero = np.zeros_like(np.take(padded, [0], axis=axis))
    cums = np.cumsum(np.concatenate([zero, padded], axis=axis), axis=axis)
    sums = (np.take(cums, np.arange(taps, n + taps), axis=axis)
            - np.take(cums, np.arange(n), axis=axis)).astype(np.float32)
    scaled = sums * box_inv_taps_f32(radius)
    return np.clip(np.floor(scaled + np.float32(0.5)), 0, 255).astype(np.int64)


def running_box_rows(rows: np.ndarray, radius: int, channels: int) -> np.ndarray:
    """(..., H, W*C) uint8 -> uint8 box blur by running sums: along the
    pixels of each channel, then along the rows of each image."""
    *lead, h, lanes = rows.shape
    x = rows.astype(np.int64).reshape(*lead, h, lanes // channels, channels)
    out = _running_box_pass(_running_box_pass(x, radius, -2), radius, -3)
    return out.astype(np.uint8).reshape(rows.shape)


def _window_box_pass(x: np.ndarray, radius: int, axis: int) -> np.ndarray:
    """One box pass of the window kernel in box mode
    (`gauss_window_rows<Box, r>`, r <= 7) along `axis`: each output adds its
    2r + 1 clamped values in f32 in input order, then the f32 scale and
    floor(x + 0.5) clamped to [0, 255]."""
    n = x.shape[axis]
    padded = np.take(x, np.clip(np.arange(-radius, n + radius), 0, n - 1),
                     axis=axis).astype(np.float32)
    acc = np.take(padded, np.arange(n), axis=axis)
    for t in range(1, 2 * radius + 1):
        acc = (acc + np.take(padded, np.arange(t, n + t), axis=axis)).astype(np.float32)
    scaled = (acc * box_inv_taps_f32(radius)).astype(np.float32)
    return np.clip(np.floor(scaled + np.float32(0.5)), 0, 255)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("radius", range(1, 8))
def test_window_box_model_equals_plain(rng, radius, channels):
    # Sums of at most 15 whole values under 256 are exact in f32, so the
    # window kernel's order gives the running sums' bits.
    h, w = 11, 13
    img = rng.integers(0, 256, size=(2, h, w * channels), dtype=np.uint8)
    x = img.reshape(2, h, w, channels)
    got = _window_box_pass(_window_box_pass(x, radius, -2), radius, -3)
    got = got.astype(np.uint8).reshape(img.shape)
    plain = blur.box_rows_plain(torch.from_numpy(img), radius, channels).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, running_box_rows(img, radius, channels))


# (shape, radius): r = 15 and 40 pass both sides of every image here; the
# last two pass only the width (14 x 9) or only the height (9 x 14).
BOX_CASES = [((9, 14), r) for r in (1, 2, 5, 15, 40)] + [
    ((14, 9), 10), ((9, 14), 10)]


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("hw,radius", BOX_CASES)
def test_running_box_model_equals_plain_and_jax(rng, hw, radius, channels):
    h, w = hw
    img = rng.integers(0, 256, size=(h, w * channels), dtype=np.uint8)
    got = running_box_rows(img, radius, channels)
    plain = blur.box_rows_plain(torch.from_numpy(img), radius, channels).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jax.jit(lambda r: box_mxu_rows(
        r, radius, channels, interpret=True))(img))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("hw,radius", BOX_CASES)
def test_running_box_model_equals_plain_and_jax_on_a_batch(rng, hw, radius,
                                                           channels):
    h, w = hw
    imgs = rng.integers(0, 256, size=(3, h, w * channels), dtype=np.uint8)
    got = running_box_rows(imgs, radius, channels)
    plain = blur.box_rows_plain(torch.from_numpy(imgs), radius, channels).numpy()
    np.testing.assert_array_equal(got, plain)
    want = np.asarray(jax.jit(lambda r: box_mxu_rows_batch(
        r, radius, channels, interpret=True))(imgs))
    np.testing.assert_array_equal(got, want)
    for i in range(3):
        np.testing.assert_array_equal(got[i], running_box_rows(imgs[i], radius,
                                                               channels))


def _band(table: torch.Tensor, depth: int, stride: int,
          radius: int) -> torch.Tensor:
    """(depth, 16) f32: band[k][n] = w[(k - n) / stride] where k - n is a
    multiple of `stride` in [0, 2r * stride], else 0 (blur.cu build_band)."""
    d = torch.arange(depth)[:, None] - torch.arange(16)[None, :]
    tap = torch.div(d, stride, rounding_mode="floor")
    on = (d >= 0) & (d % stride == 0) & (tap <= 2 * radius)
    return torch.where(on, table[tap.clamp(0, 2 * radius)], 0.0)


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def _band_pass(xp: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
               radius: int, stride: int, n_out: int) -> torch.Tensor:
    """One pass along the last axis of (..., L) f32, whose first `radius *
    stride` elements are the left halo: 16-output tiles, each the product of
    its (depth,) input window with the hi and lo bands in k-chunks of 16,
    accumulated in f32; then hi + lo, quantized."""
    depth = _round16(16 + 2 * radius * stride)
    tiles = (n_out + 15) // 16
    need = (tiles - 1) * 16 + depth
    xp = torch.nn.functional.pad(xp, (0, max(need - xp.shape[-1], 0)))
    windows = xp[..., :need].unfold(-1, depth, 16)        # (..., tiles, depth)
    out = []
    for table in (hi, lo):
        band = _band(table, depth, stride, radius)
        acc = torch.zeros(*windows.shape[:-1], 16)
        for ks in range(depth // 16):
            chunk = slice(ks * 16, ks * 16 + 16)
            acc = acc + windows[..., chunk] @ band[chunk]
        out.append(acc)
    total = (out[0] + out[1]).flatten(-2)[..., :n_out]
    return torch.clamp(torch.floor(total + 0.5), 0.0, 255.0)


def tensor_core_band_rows(rows: torch.Tensor, hi: torch.Tensor,
                          lo: torch.Tensor, radius: int,
                          channels: int) -> torch.Tensor:
    """(..., H, W*C) uint8 -> uint8: band_mma_rows's products in plain torch."""
    x = rows.to(torch.float32)
    lanes = x.shape[-1]
    h = _band_pass(interleaved._pad_pixels_lr(x, radius, channels), hi, lo,
                   radius, channels, lanes)
    hv = interleaved._pad_rows_edge(h, radius).transpose(-1, -2)
    v = _band_pass(hv, hi, lo, radius, 1, x.shape[-2]).transpose(-1, -2)
    return v.to(torch.uint8)


def _assert_band_close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= blur.BAND_MAX_DIFF, diff.max()
    assert (diff > 0).mean() <= blur.BAND_MAX_FRACTION, (diff > 0).sum()


BAND_SHAPES = [(40, 50, 3), (33, 41, 1), (30, 37, 4)]


@pytest.mark.parametrize("shape", BAND_SHAPES)
@pytest.mark.parametrize("radius,sigma", [(3, 2.0), (15, 5.0), (31, 8.0)])
def test_tensor_core_band_model_within_tolerance(rng, shape, radius, sigma):
    h, w, c = shape
    img = rng.integers(0, 256, size=(h, w * c), dtype=np.uint8)
    table = gaussian_kernel_f32(radius, sigma)
    hi, lo = (weights_to_torch(t, CPU) for t in bf16_split(table))
    rows = torch.from_numpy(img)
    got = tensor_core_band_rows(rows, hi, lo, radius, c).numpy()
    _assert_band_close(got, blur.gaussian_band_rows_plain(rows, hi, lo, radius,
                                                          c).numpy())
    want = np.asarray(jax.jit(lambda r, ww: gaussian_mxu_rows(
        r, ww, radius, c, interpret=True))(img, table))
    _assert_band_close(got, want)


@pytest.mark.parametrize("radius,sigma", [(3, 2.0), (15, 5.0)])
def test_tensor_core_band_model_on_a_batch(rng, radius, sigma):
    imgs = rng.integers(0, 256, size=(3, 21, 26 * 3), dtype=np.uint8)
    table = gaussian_kernel_f32(radius, sigma)
    hi, lo = (weights_to_torch(t, CPU) for t in bf16_split(table))
    rows = torch.from_numpy(imgs)
    got = tensor_core_band_rows(rows, hi, lo, radius, 3).numpy()
    want = np.asarray(jax.jit(lambda r, ww: gaussian_mxu_rows_batch(
        r, ww, radius, 3, interpret=True))(imgs, table))
    _assert_band_close(got, want)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], tensor_core_band_rows(rows[i], hi, lo, radius, 3).numpy())


@pytest.mark.parametrize("radius,fn_name", [
    (1, "gip_box_window_rows"), (64, "gip_box_window_rows"),
    (65, "gip_box_wide_rows"), (4000, "gip_box_wide_rows")])
def test_box_rows_routes_on_the_radius(monkeypatch, radius, fn_name):
    # The window kernel up to BOX_WINDOW_MAX_RADIUS, the wide one past it;
    # off the CPU a wrapper launches or raises, never serves the plain
    # version.
    rows = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="cuda device"):
        blur.box_rows(rows, radius, 3)
    launched = []
    monkeypatch.setattr(blur, "_launch",
                        lambda name, x, *args, **kw: launched.append(name) or x)
    blur.box_rows(rows, radius, 3)
    assert launched == [fn_name]


def test_card_only_caps_raise_before_any_launch():
    rows = torch.empty((4, 17 * 5), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="channels"):
        blur.box_rows(rows, 2, 17)
    w = torch.empty(65, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="band kernel"):
        blur.gaussian_band_rows(rows, w, w, 32, 5)
    w = torch.empty(7, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="band kernel"):
        blur.gaussian_band_rows(rows, w, w, 3, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 31, 3), (2, 2, 3), (1, 7, 1), (19, 23, 4)])
@pytest.mark.parametrize("radius", [40, 64, 65, 100])
def test_box_at_wide_radii_equals_plain_on_card(rng, shape, radius):
    # r = 40 and up pass the width and height of every shape here.
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    h, w, c = shape
    rows = torch.from_numpy(
        rng.integers(0, 256, size=(h, w * c), dtype=np.uint8)).to("cuda")
    assert torch.equal(blur.box_rows(rows, radius, c),
                       blur.box_rows_plain(rows, radius, c))
    batch = torch.from_numpy(
        rng.integers(0, 256, size=(3, h, w * c), dtype=np.uint8)).to("cuda")
    out = blur.box_rows(batch, radius, c)
    assert torch.equal(out, blur.box_rows_plain(batch, radius, c))
    for i in range(3):
        assert torch.equal(out[i], blur.box_rows(batch[i].contiguous(), radius, c))
