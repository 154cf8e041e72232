"""The weighted gaussian at wide radii (`gauss_pair_rows`, ops/cuda/blur.cu),
checked on the CPU.

From `blur.cu`'s crossover (`kPairMinRadius`) to r = 15 and at r = 31, a
weighted launch whose table reads the same backwards, bit for bit, runs
`gauss_pair_rows`: register runs of 32 outputs in each pass (32 pixels of
one channel, 32 rows of one lane), one product a symmetric tap pair, a ring
of horizontal rows in chunks of 32.  It does not run here, so a numpy model
of its order of work, with its geometry, stands in for it:

* strips of 32-pixel runs, staged with their pixels clamped at the image's
  edge; row bands of a multiple of 32 rows; the ring's chunks (the model
  also takes chunks of two vertical runs, the last of which may fall past
  the band's rows), the first
  chunk's rows below the band's halo and the rows past the last one an
  output reads left uncomputed (the ring starts with noise, which must not
  reach an output);
* each input value's product with tap m <= r formed once and added to the
  outputs that take it as tap m and as tap 2r - m, inputs in order, so each
  output adds its taps in tap order; u8 values made f32 exactly (the
  kernel converts by I2FP, the model as 2^23 + v less 2^23: the same
  floats), sums rounded by floor(x + 0.5) as an add rounded down.

The model must equal the plain version bit for bit and the JAX package's
Pallas kernel in interpret mode, on rows, on planes with halo rows and on a
batch, and must not depend on the strip or the band.  The table's check
(`blur.pair_table`: symmetric to the bit, taps >= 0 summing to at most
1 + 2^-10, so that the kernel's rounding needs no clamp) is held to the
tables the port and the JAX package build, and a table that is not
symmetric is shown to need the window kernel.  The card's cases are in `tests/test_torch_wide_radius.py`, which
imports no JAX.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops.pallas.blur import (
    gaussian_pallas_rows,
    gaussian_pallas_rows_batch,
)
from gpu_image_processing_tpu.ops.weights import (
    gaussian_kernel_f32 as jax_gaussian_kernel_f32,
)
from gpu_image_processing_tpu_torch.ops.cuda import blur, blur_planar
from gpu_image_processing_tpu_torch.ops.weights import (
    gaussian_kernel_f32,
    weights_to_torch,
)

from . import oracle_numpy as oracle
from .test_torch_rows_redesign import add_round_down, quantize_u8_int, u8_to_f32

CPU = torch.device("cpu")
F32 = np.float32
RUN = 32                 # blur.cu kPairRun
CHUNK = 32               # blur.cu kPairRun: the ring's chunks
MAX_LANES = 384          # blur.cu kPairMaxLanes
BLUR_CU = (Path(__file__).resolve().parents[1] / "gpu_image_processing_tpu_torch"
           / "ops" / "cuda" / "blur.cu")
# The radii gauss_pair_rows serves, from the crossover (at least 8).
RADII = list(range(8, 16)) + [31]


def sigma_of(radius: int) -> float:
    return {15: 20.0, 31: 8.0}.get(radius, radius / 2.0)


def pair_run(x: np.ndarray, table: np.ndarray, radius: int) -> np.ndarray:
    """(..., RUN + 2r) u8 inputs of runs -> (..., RUN) f32 sums: input j's
    product with tap m <= r, formed once, is tap m of output j - m and tap
    2r - m of output j - 2r + m (blur.cu add_pair_input)."""
    acc = [None] * RUN
    for j in range(RUN + 2 * radius):
        v = u8_to_f32(x[..., j].astype(np.uint32))
        for m in range(radius + 1):
            k, k2 = j - m, j - 2 * radius + m
            first = 0 <= k < RUN
            second = m < radius and 0 <= k2 < RUN
            if first or second:
                p = (v * table[m]).astype(F32)
                if first:
                    acc[k] = p if m == 0 else (acc[k] + p).astype(F32)
                if second:
                    acc[k2] = (acc[k2] + p).astype(F32)
    return np.stack(acc, axis=-1)


def pair_model(rows: np.ndarray, table: np.ndarray, radius: int,
               channels: int, runs: int, band_rows: int,
               halo: bool = False, chunk_rows: int = CHUNK) -> np.ndarray:
    """(..., H[+2r], W*C) uint8 -> gauss_pair_rows' result, strip by strip,
    band by band, chunk by chunk, each image of a batch on its own; with
    `halo`, each image carries r given rows above and below."""
    r, c = radius, channels
    assert band_rows % RUN == 0 and chunk_rows % RUN == 0
    assert runs * RUN * c <= MAX_LANES
    lead = rows.shape[:-2]
    rows_in, lanes = rows.shape[-2:]
    h = rows_in - 2 * r if halo else rows_in
    w = lanes // c
    imgs = rows.reshape(-1, rows_in, w, c)
    out = np.zeros((imgs.shape[0], h, w, c), np.uint8)
    strip_px = runs * RUN
    chunks = (2 * r + chunk_rows - 1) // chunk_rows + 1
    skip = (chunks - 1) * chunk_rows - 2 * r
    noise = np.random.default_rng(7)
    for b, img in enumerate(imgs):
        for px0 in range(0, w, strip_px):
            valid = min(strip_px, w - px0)
            cols = np.clip(np.arange(px0 - r, px0 + strip_px + r), 0, w - 1)
            live_runs = (valid + RUN - 1) // RUN
            for y0 in range(0, h, band_rows):
                y_end = min(y0 + band_rows, h)
                v_first = y0 + r - (chunks - 1) * chunk_rows
                v_last = y_end - 1 + r
                last_chunk = ((y_end - y0 + chunk_rows - 1) // chunk_rows
                              + chunks - 2)
                ring = noise.integers(0, 256, (chunks * chunk_rows, strip_px, c),
                                      dtype=np.uint8)
                for ci in range(last_chunk + 1):
                    vs = v_first + ci * chunk_rows + np.arange(chunk_rows)
                    ys = (np.clip(vs + r, 0, rows_in - 1) if halo
                          else np.clip(vs, 0, h - 1))
                    staged = img[ys][:, cols]         # (chunk, px + 2r, C)
                    for q in range(live_runs):
                        x = np.moveaxis(staged[:, q * RUN:q * RUN + RUN + 2 * r],
                                        1, -1)        # (chunk, C, RUN + 2r)
                        got = quantize_u8_int(pair_run(x, table, r))
                        for k in np.flatnonzero((vs >= y0 - r) & (vs <= v_last)):
                            slot = (ci % chunks) * chunk_rows + k
                            ring[slot, q * RUN:q * RUN + RUN] = got[k].T
                    n = ci - (chunks - 1)
                    if n < 0:
                        continue
                    for sub in range(chunk_rows // RUN):
                        yn = y0 + n * chunk_rows + sub * RUN
                        if yn >= y_end:
                            break
                        first = skip + sub * RUN
                        at = [((n + (first + j) // chunk_rows) % chunks) * chunk_rows
                              + (first + j) % chunk_rows
                              for j in range(2 * r + RUN)]
                        win = ring[at][:, :valid].reshape(2 * r + RUN, valid * c)
                        v = quantize_u8_int(pair_run(win.T, table, r)).T
                        k_out = min(RUN, y_end - yn)
                        out[b, yn:yn + k_out, px0:px0 + valid] = v[:k_out].reshape(
                            k_out, valid, c)
    return out.reshape(*lead, h, lanes)


def _image(rng, h, w, c, lead=()):
    return rng.integers(0, 256, size=(*lead, h, w * c), dtype=np.uint8)


def _most_runs(channels: int) -> int:
    return MAX_LANES // RUN // channels


def _plain(rows: np.ndarray, table: np.ndarray, radius: int,
           channels: int) -> np.ndarray:
    return blur.gaussian_rows_plain(torch.from_numpy(rows),
                                    weights_to_torch(table, CPU), radius,
                                    channels).numpy()


# Two strips at every channel count (a part strip last), and a height
# below one band.
PAIR_SHAPES = [(37, 170, 3), (21, 520, 1), (12, 70, 4)]


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("radius", RADII)
def test_pair_model_equals_plain(rng, radius, channels):
    h, w, _ = next(s for s in PAIR_SHAPES if s[2] == channels)
    rows = _image(rng, h, w, channels)
    table = gaussian_kernel_f32(radius, sigma_of(radius))
    got = pair_model(rows, table, radius, channels,
                     runs=_most_runs(channels), band_rows=32)
    np.testing.assert_array_equal(got, _plain(rows, table, radius, channels))


@pytest.mark.parametrize("radius", [8, 12, 15, 31])
@pytest.mark.parametrize("shape", [(37, 170, 3), (19, 23, 1), (17, 29, 4)])
def test_pair_model_equals_jax(rng, shape, radius):
    h, w, c = shape
    rows = _image(rng, h, w, c)
    table = gaussian_kernel_f32(radius, sigma_of(radius))
    got = pair_model(rows, table, radius, c, runs=_most_runs(c), band_rows=64)
    want = np.asarray(jax.jit(lambda x, t: gaussian_pallas_rows(
        x, t, radius, c, interpret=True))(rows, table))
    np.testing.assert_array_equal(got, want)


# Widths of 161 pixels (a strip and one pixel) and of one pixel, heights
# of one row, of fewer rows than r and of more than one band.
@pytest.mark.parametrize("hw", [(5, 161), (1, 161), (70, 1), (9, 1)])
@pytest.mark.parametrize("radius", [8, 15, 31])
def test_pair_model_at_narrow_and_short_images(rng, hw, radius):
    h, w = hw
    rows = _image(rng, h, w, 3)
    table = gaussian_kernel_f32(radius, sigma_of(radius))
    got = pair_model(rows, table, radius, 3, runs=4, band_rows=32)
    np.testing.assert_array_equal(got, _plain(rows, table, radius, 3))


@pytest.mark.parametrize("radius", [8, 15, 31])
def test_pair_model_on_planes_with_halo_rows(rng, radius):
    # Row bands of a split image, each with r given halo rows above and
    # below (the planar blur's rows_prepadded), one plane at a time.
    planes = rng.integers(0, 256, size=(3, 40 + 2 * radius, 75), dtype=np.uint8)
    table = gaussian_kernel_f32(radius, sigma_of(radius))
    got = pair_model(planes, table, radius, 1, runs=12, band_rows=32,
                     halo=True)
    want = blur_planar.gaussian_planar_plain(
        torch.from_numpy(planes), weights_to_torch(table, CPU), radius,
        rows_prepadded=True).numpy()
    np.testing.assert_array_equal(got, want)
    # Without halo rows the planes clamp at their own edges.
    got = pair_model(planes, table, radius, 1, runs=12, band_rows=32)
    want = blur_planar.gaussian_planar_plain(
        torch.from_numpy(planes), weights_to_torch(table, CPU), radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [8, 15])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_pair_model_on_a_batch(rng, radius, channels):
    imgs = _image(rng, 13, 90, channels, lead=(3,))
    table = gaussian_kernel_f32(radius, sigma_of(radius))
    got = pair_model(imgs, table, radius, channels, runs=2, band_rows=32)
    np.testing.assert_array_equal(got, _plain(imgs, table, radius, channels))
    for i in range(3):
        np.testing.assert_array_equal(got[i], pair_model(
            imgs[i], table, radius, channels, runs=2, band_rows=32))
        np.testing.assert_array_equal(got[i], oracle.gaussian_blur(
            imgs[i].reshape(13, 90, channels), table, radius).reshape(13, -1))
    # As in test_torch_rows_redesign's batch case: on some seeded images
    # (here C = 4, r = 8) the JAX batch kernel, interpreted by XLA on the
    # CPU, rounds a few bytes of 14,040 the other way from the numpy oracle
    # (XLA contracts multiply-adds); the oracle above settles those bits.
    want = np.asarray(jax.jit(lambda x, t: gaussian_pallas_rows_batch(
        x, t, radius, channels, interpret=True))(imgs, table))
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("chunk_rows", [32, 64])
@pytest.mark.parametrize("runs,band_rows", [(1, 32), (2, 96), (3, 64), (4, 224)])
def test_pair_model_does_not_depend_on_the_strip_the_band_or_the_chunk(
        rng, runs, band_rows, chunk_rows):
    rows = _image(rng, 45, 200, 3)
    table = gaussian_kernel_f32(15, 20.0)
    np.testing.assert_array_equal(
        pair_model(rows, table, 15, 3, runs=runs, band_rows=band_rows,
                   chunk_rows=chunk_rows),
        _plain(rows, table, 15, 3))


# -- the table's check ---------------------------------------------------------

@pytest.mark.parametrize("radius", range(1, 32))
def test_the_tables_the_port_and_jax_build_are_taken(radius):
    for sigma in (0.5, 1.0, 2.0, 5.0, radius / 3.0 + 0.1, 20.0, 33.3):
        for table in (gaussian_kernel_f32(radius, sigma),
                      jax_gaussian_kernel_f32(radius, sigma)):
            assert blur.pair_table(np.asarray(table, F32).tobytes())


def test_a_table_off_by_a_bit_is_not_taken():
    table = np.array(gaussian_kernel_f32(15, 20.0), F32)
    assert blur.pair_table(table.tobytes())
    for t in (0, 7, 29):
        skewed = table.copy()
        skewed[t] = np.nextafter(skewed[t], F32(1))
        assert not blur.pair_table(skewed.tobytes())
    # Equal as floats, not as bits: the kernel's products need the bits.
    signed = np.zeros(5, F32)
    signed[0] = -0.0
    assert not blur.pair_table(signed.tobytes())
    # The centre tap has no mirror.
    centre = table.copy()
    centre[15] = 0.0
    assert blur.pair_table(centre.tobytes())


def test_a_table_that_could_leave_the_byte_is_not_taken():
    # The kernel rounds with no clamp, so it takes only taps >= 0 whose sum
    # keeps every output below 255.5.
    table = np.array(gaussian_kernel_f32(8, 4.0), F32)
    negative = table.copy()
    negative[[0, 16]] = -negative[0]
    assert not blur.pair_table(negative.tobytes())
    heavy = (table * F32(1.002)).astype(F32)
    assert not blur.pair_table(heavy.tobytes())
    light = (table * F32(1.0009)).astype(F32)
    assert blur.pair_table(light.tobytes())
    nan = table.copy()
    nan[[3, 13]] = np.nan
    assert not blur.pair_table(nan.tobytes())


def quantize_u8_low(x: np.ndarray) -> np.ndarray:
    """blur.cu quantize_u8_low: the low byte of the bits of (x + 0.5
    rounded to nearest) + 1.5 * 2^23 rounded down, no clamp."""
    t = (x.astype(F32) + F32(0.5)).astype(F32)
    return (add_round_down(t, 12582912.0).view(np.uint32) & 0xFF).astype(np.uint8)


def test_the_unclamped_rounding_holds_on_the_sums_the_tables_allow(rng):
    # Every .5 tie from 0.5 to 254.5 and the floats around it, the ends of
    # [0, 255.5), and random sums in it: the clamped rounding's bytes.
    ties = np.arange(0, 255, dtype=F32) + F32(0.5)
    near = [ties]
    for step in (F32(np.inf), F32(-np.inf)):
        x = ties
        for _ in range(4):
            x = np.nextafter(x, step)
            near.append(x)
    ends = np.array([0.0, 255.0, 255.25, np.nextafter(F32(255.5), F32(0))], F32)
    x = np.concatenate(near + [ends, rng.uniform(0, 255.5, 50000).astype(F32)])
    np.testing.assert_array_equal(quantize_u8_low(x), quantize_u8_int(x))
    # The bound: 255 sums of taps of 1 + 2^-10, each product and sum
    # rounded up, stay below 255.5.
    worst = 255.0 * (1 + 2.0 ** -10) * (1 + 2.0 ** -24) ** 63
    assert worst < 255.3


def test_the_pair_products_need_a_symmetric_table(rng):
    # With taps that differ from their mirror, one product a pair is
    # another function: such a table goes to the window kernel.
    rows = _image(rng, 20, 70, 3)
    table = np.array(gaussian_kernel_f32(8, 4.0), F32)
    table[0] *= F32(3)
    assert not blur.pair_table(table.tobytes())
    assert not np.array_equal(
        pair_model(rows, table, 8, 3, runs=4, band_rows=32),
        _plain(rows, table, 8, 3))


def test_the_crossover_is_a_constant_of_blur_cu_from_8():
    source = BLUR_CU.read_text()
    crossover = int(re.search(r"constexpr int kPairMinRadius = (\d+);",
                              source).group(1))
    assert 8 <= crossover <= 15
    assert "8 << 8 : 7 << 8" in source
    assert [blur._FUNCTIONS[code].format(15) for code in (7, 8)] == [
        "gauss_pair_rows<15, 0>", "gauss_pair_rows<15, 3>"]
