"""The decompositions of the redesigned rows gaussian and Sobel, checked on
the CPU.

`gauss_window_rows` (ops/cuda/blur.cu, `gaussian_rows` and
`gaussian_folded_rows`) and `sobel_tile_rows` (ops/cuda/sobel.cu,
`sobel_rows` and `sobel_f32_rows`) do not run here, so each gets a numpy
model of its order of work with the kernels' own geometry:

* the gaussian: strips of at most 512 lanes (a multiple of 16 pixels),
  each staged with its pixels clamped at the image's edge; row bands (a
  multiple of 16 rows); windows of 2r + 16 quantized horizontal rows, the
  next window taking the last 2r rows of this one and 16 new ones; the
  weighted taps accumulated in input order over runs of 16 pixels and
  columns of 16 rows (register windows), the folded taps read per output;
  u8 values made f32 as 2^23 + v less 2^23, sums rounded by
  floor(x + 0.5) as an add rounded down;
* Sobel: 8 x 128 output tiles of (8 + 2) x (128 + 2) staged pixels,
  clamped at the image's edge, one grey value a staged pixel, the 3x3
  magnitude in edges.cuh's term order, a zero border.

Each model must equal the plain version bit for bit and the JAX package's
Pallas kernels run in interpret mode, as its own tests run them on the CPU
(the JAX colour Sobel is held to tests/sobel_tolerance.py: XLA contracts the
grey rule into FMAs; where the interpreted JAX blur rounds a tie the other
way, the numpy oracle settles the bits).  Tests marked `cuda` compare the kernels with their
plain versions on the card.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops.pallas.blur import (
    gaussian_pallas_rows,
    gaussian_pallas_rows_batch,
)
from gpu_image_processing_tpu.ops.pallas.sobel import (
    sobel_pallas_rows,
    sobel_pallas_rows_batch,
)
from gpu_image_processing_tpu.ops.pallas.sobel_mxu import sobel_mxu_rows
from gpu_image_processing_tpu.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu_torch.ops.cuda import blur, sobel
from gpu_image_processing_tpu_torch.ops.weights import weights_to_torch

from . import oracle_numpy as oracle
from .sobel_tolerance import assert_sobel_close

CPU = torch.device("cpu")
F32 = np.float32

# The kernels' geometry (blur.cu, sobel.cu).
STRIP_LANES, RUN_H, CHUNK = 512, 16, 16
TILE_W, TILE_H = 128, 8


# -- the exact conversions of launch.cuh ---------------------------------------

def u8_to_f32(v: np.ndarray) -> np.ndarray:
    """2^23 + v, as f32 bits, less 2^23 (launch.cuh u8_to_f32)."""
    big = (np.uint32(0x4B000000) | v.astype(np.uint32)).view(F32)
    return (big - F32(8388608.0)).astype(F32)


def add_round_down(a: np.ndarray, b: float) -> np.ndarray:
    """a + b in f32 rounded toward -inf: the exact sum in f64, then the f32
    at or below it."""
    exact = a.astype(np.float64) + float(b)
    near = exact.astype(F32)
    return np.where(near.astype(np.float64) > exact,
                    np.nextafter(near, F32(-np.inf)), near).astype(F32)


def quantize_u8_int(x: np.ndarray) -> np.ndarray:
    """floor(x + 0.5) clamped to [0, 255] by the round-down add of 1.5 * 2^23
    (launch.cuh quantize_u8_int)."""
    t = (x.astype(F32) + F32(0.5)).astype(F32)
    bits = add_round_down(t, 12582912.0).view(np.int32).astype(np.int64)
    return np.clip(bits - 0x4B400000, 0, 255).astype(np.uint8)


def quantize_u8_ref(x: np.ndarray) -> np.ndarray:
    return np.clip(np.floor((x.astype(F32) + F32(0.5)).astype(F32)), 0, 255
                   ).astype(np.uint8)


def test_u8_to_f32_is_exact_for_pair_sums():
    v = np.arange(0, 511, dtype=np.uint32)
    np.testing.assert_array_equal(u8_to_f32(v), v.astype(F32))


def test_round_down_quantize_equals_floor_half_up(rng):
    # Every .5 tie from -3.5 to 300.5 and the f32 values around it, and
    # random sums in the blur's range.
    ties = np.arange(-4, 301, dtype=F32) + F32(0.5)
    near = [ties]
    for _ in range(4):
        near.append(np.nextafter(near[-1], F32(np.inf)))
    lo = [ties]
    for _ in range(4):
        lo.append(np.nextafter(lo[-1], F32(-np.inf)))
    x = np.concatenate(near + lo + [rng.uniform(-2, 300, 20000).astype(F32),
                                    np.arange(0, 256, dtype=F32)])
    np.testing.assert_array_equal(quantize_u8_int(x), quantize_u8_ref(x))


# -- the gaussian window kernel --------------------------------------------------

def strip_pixels(channels: int) -> int:
    return max(STRIP_LANES // channels // RUN_H * RUN_H, RUN_H)


def horizontal_rows(staged: np.ndarray, table: np.ndarray, radius: int,
                    valid_px: int, folded: bool) -> np.ndarray:
    """(rows, strip_px + 2r, C) staged u8 -> (rows, valid_px, C) u8: runs
    of RUN_H pixels of one channel; weighted in input order from a window of
    RUN_H + 2r values, folded per output."""
    rows, _, c = staged.shape
    runs = (valid_px + RUN_H - 1) // RUN_H
    out = np.zeros((rows, runs * RUN_H, c), np.uint8)
    x = staged.astype(np.uint32)
    for run in range(runs):
        p0 = run * RUN_H
        if folded:
            for k in range(RUN_H):
                xk = x[:, p0 + k:p0 + k + 2 * radius + 1]
                out[:, p0 + k] = quantize_u8_int(folded_sum(
                    lambda t: xk[:, t], table, radius))
        else:
            acc = [None] * RUN_H
            for j in range(RUN_H + 2 * radius):
                v = u8_to_f32(x[:, p0 + j])
                for k in range(RUN_H):
                    t = j - k
                    if 0 <= t <= 2 * radius:
                        term = (v * table[t]).astype(F32)
                        acc[k] = term if t == 0 else (acc[k] + term).astype(F32)
            for k in range(RUN_H):
                out[:, p0 + k] = quantize_u8_int(acc[k])
    return out[:, :valid_px]


def folded_sum(x, table: np.ndarray, radius: int) -> np.ndarray:
    """sum over t < r of (x(t) + x(2r - t)) * w[t] in t order, then
    + x(r) * w[r]; x(t) the u8 values of tap t."""
    acc = None
    for t in range(radius):
        term = (u8_to_f32(x(t) + x(2 * radius - t)) * table[t]).astype(F32)
        acc = term if acc is None else (acc + term).astype(F32)
    return (acc + (u8_to_f32(x(radius)) * table[radius]).astype(F32)).astype(F32)


def vertical_rows(win: np.ndarray, table: np.ndarray, radius: int,
                  folded: bool) -> np.ndarray:
    """(2r + CHUNK, lanes) u8 window -> (CHUNK, lanes) u8: output row k
    reads window rows k .. k + 2r; weighted in input order (a column of
    CHUNK accumulators), folded per output."""
    x = win.astype(np.uint32)
    if folded:
        return np.stack([quantize_u8_int(folded_sum(
            lambda t, k=k: x[k + t], table, radius)) for k in range(CHUNK)])
    acc = [None] * CHUNK
    for j in range(CHUNK + 2 * radius):
        v = u8_to_f32(x[j])
        for k in range(CHUNK):
            t = j - k
            if 0 <= t <= 2 * radius:
                term = (v * table[t]).astype(F32)
                acc[k] = term if t == 0 else (acc[k] + term).astype(F32)
    return np.stack([quantize_u8_int(a) for a in acc])


def gauss_window_model(rows: np.ndarray, table: np.ndarray, radius: int,
                       channels: int, band_rows: int,
                       folded: bool = False) -> np.ndarray:
    """(..., H, W*C) uint8 -> the kernel's result, strip by strip, band by
    band, window by window, each image of a batch on its own."""
    lead = rows.shape[:-2]
    h, lanes = rows.shape[-2:]
    w = lanes // channels
    imgs = rows.reshape(-1, h, w, channels)
    out = np.zeros_like(imgs)
    sp = strip_pixels(channels)
    assert band_rows % CHUNK == 0
    for b, img in enumerate(imgs):
        for px0 in range(0, w, sp):
            valid = min(sp, w - px0)
            cols = np.clip(np.arange(px0 - radius, px0 + sp + radius), 0, w - 1)

            def new_rows(v0, n):
                # Staged rows: image rows clamp(v), pixels clamped.
                ys = np.clip(np.arange(v0, v0 + n), 0, h - 1)
                staged = img[ys][:, cols]
                return horizontal_rows(staged, table, radius, valid,
                                       folded).reshape(n, valid * channels)

            for y0 in range(0, h, band_rows):
                y_end = min(y0 + band_rows, h)
                win = new_rows(y0 - radius, 2 * radius + CHUNK)
                for yc in range(y0, y_end, CHUNK):
                    v = vertical_rows(win, table, radius, folded)
                    n = min(CHUNK, y_end - yc)
                    out[b, yc:yc + n, px0:px0 + valid] = v[:n].reshape(
                        n, valid, channels)
                    win = np.concatenate(
                        [win[CHUNK:CHUNK + 2 * radius],
                         new_rows(yc + CHUNK + radius, CHUNK)])
    return out.reshape(*lead, h, lanes)


GAUSS = [(1, 1.0), (2, 1.5), (3, 2.0), (15, 8.0), (31, 8.0)]
# Ragged against the strip and the band: two strips at C = 3 and 4, a C = 1
# row past one strip, a single row, 2 x 2, and H < 2r (5 rows).
GAUSS_SHAPES = [(37, 301, 3), (20, 700, 1), (33, 150, 4), (1, 7, 1), (2, 2, 3),
                (5, 40, 3)]


def _image(rng, h, w, c, lead=()):
    return rng.integers(0, 256, size=(*lead, h, w * c), dtype=np.uint8)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("radius,sigma", GAUSS)
@pytest.mark.parametrize("shape", GAUSS_SHAPES)
def test_gauss_window_model_equals_plain(rng, shape, radius, sigma, folded):
    h, w, c = shape
    rows = _image(rng, h, w, c)
    table = gaussian_kernel_f32(radius, sigma)
    got = gauss_window_model(rows, table, radius, c, band_rows=32,
                             folded=folded)
    plain = (blur.gaussian_folded_rows_plain if folded
             else blur.gaussian_rows_plain)
    want = plain(torch.from_numpy(rows), weights_to_torch(table, CPU), radius,
                 c).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (3, 2.0), (15, 8.0), (31, 8.0)])
@pytest.mark.parametrize("shape", [(37, 301, 3), (19, 23, 1), (17, 29, 4), (2, 2, 3)])
def test_gauss_window_model_equals_jax(rng, shape, radius, sigma):
    h, w, c = shape
    rows = _image(rng, h, w, c)
    table = gaussian_kernel_f32(radius, sigma)
    got = gauss_window_model(rows, table, radius, c, band_rows=48)
    want = np.asarray(jax.jit(lambda r, ww: gaussian_pallas_rows(
        r, ww, radius, c, interpret=True))(rows, table))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (2, 1.5)])
def test_gauss_window_model_folded_equals_jax(rng, radius, sigma):
    rows = _image(rng, 21, 190, 3)
    table = gaussian_kernel_f32(radius, sigma)
    got = gauss_window_model(rows, table, radius, 3, band_rows=32, folded=True)
    want = np.asarray(jax.jit(lambda r, ww: gaussian_pallas_rows(
        r, ww, radius, 3, interpret=True, folded=True))(rows, table))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius,sigma", [(2, 1.5), (3, 2.0), (15, 8.0)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_gauss_window_model_on_a_batch(rng, radius, sigma, channels):
    imgs = _image(rng, 13, 180, channels, lead=(3,))
    table = gaussian_kernel_f32(radius, sigma)
    got = gauss_window_model(imgs, table, radius, channels, band_rows=32)
    for i in range(3):
        np.testing.assert_array_equal(got[i], gauss_window_model(
            imgs[i], table, radius, channels, band_rows=32))
        np.testing.assert_array_equal(got[i], oracle.gaussian_blur(
            imgs[i].reshape(13, 180, channels), table, radius).reshape(13, -1))
    # On some of these seeded images (C = 4, r = 2 and 3) the JAX kernel,
    # interpreted by XLA on the CPU, rounds 1 to 3 of 28,080 bytes the other
    # way from the numpy oracle, single image and batch alike; the oracle
    # above settles those bits, and JAX is held within 1 on 0.1%.
    want = np.asarray(jax.jit(lambda r, ww: gaussian_pallas_rows_batch(
        r, ww, radius, channels, interpret=True))(imgs, table))
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("band_rows", [16, 32, 80])
def test_gauss_window_model_does_not_depend_on_the_band(rng, band_rows):
    rows = _image(rng, 45, 260, 3)
    table = gaussian_kernel_f32(15, 8.0)
    np.testing.assert_array_equal(
        gauss_window_model(rows, table, 15, 3, band_rows=band_rows),
        gauss_window_model(rows, table, 15, 3, band_rows=48))


# -- the Sobel tile kernel -------------------------------------------------------

def grey_f32(px: np.ndarray, level: int) -> np.ndarray:
    """(..., C) u8 -> f32 grey in the reference's order, quantized at
    level 2."""
    x = px.astype(F32)
    if px.shape[-1] == 1:
        g = x[..., 0]
    else:
        g = ((F32(0.299) * x[..., 0]).astype(F32)
             + (F32(0.587) * x[..., 1]).astype(F32)).astype(F32)
        g = (g + (F32(0.114) * x[..., 2]).astype(F32)).astype(F32)
    return quantize_u8_ref(g).astype(F32) if level == 2 else g


def magnitude(g: np.ndarray) -> np.ndarray:
    """edges.cuh sobel_magnitude over the 3x3 windows of a (rows + 2,
    cols + 2) grey tile: (rows, cols)."""
    def at(dy, dx):
        return g[dy:dy + g.shape[0] - 2, dx:dx + g.shape[1] - 2]

    def mul(k, v):
        return (F32(k) * v).astype(F32)

    def add(a, b):
        return (a + b).astype(F32)

    gx = mul(-1, at(0, 0))
    for k, dy, dx in ((1, 0, 2), (-2, 1, 0), (2, 1, 2), (-1, 2, 0), (1, 2, 2)):
        gx = add(gx, mul(k, at(dy, dx)))
    gy = mul(-1, at(0, 0))
    for k, dy, dx in ((-2, 0, 1), (-1, 0, 2), (1, 2, 0), (2, 2, 1), (1, 2, 2)):
        gy = add(gy, mul(k, at(dy, dx)))
    m = np.sqrt(add((gx * gx).astype(F32), (gy * gy).astype(F32))).astype(F32)
    return np.floor((np.minimum(m, F32(255)) + F32(0.5)).astype(F32))


def column_magnitude(g: np.ndarray, whole: bool) -> np.ndarray:
    """edges.cuh SobelColumn over the 3x3 windows of a (rows + 2, cols + 2)
    grey tile: the products by +-1 and +-2 folded into subtractions and
    doublings, and for whole-number grey (`whole`) gx and gy from each
    row's d = right - left and s = left + 2 middle + right."""
    def at(dy, dx):
        return g[dy:dy + g.shape[0] - 2, dx:dx + g.shape[1] - 2]

    def f(v):
        return v.astype(F32)

    if whole:
        d = f(g[:, 2:] - g[:, :-2])
        s = f(f(g[:, :-2] + g[:, 2:]) + f(g[:, 1:-1] + g[:, 1:-1]))
        gx = f(f(d[:-2] + d[2:]) + f(d[1:-1] + d[1:-1]))
        gy = f(s[2:] - s[:-2])
    else:
        gx = f(at(0, 2) - at(0, 0))
        gx = f(gx - f(F32(2) * at(1, 0)))
        gx = f(gx + f(F32(2) * at(1, 2)))
        gx = f(f(gx - at(2, 0)) + at(2, 2))
        gy = f(-at(0, 0) - f(F32(2) * at(0, 1)))
        gy = f(f(gy - at(0, 2)) + at(2, 0))
        gy = f(f(gy + f(F32(2) * at(2, 1))) + at(2, 2))
    m = np.sqrt(f(f(gx * gx) + f(gy * gy))).astype(F32)
    return np.floor(f(np.minimum(m, F32(255)) + F32(0.5)))


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("channels", [1, 3])
def test_sobel_column_arithmetic_keeps_the_term_order_bits(rng, level, channels):
    # Folding the exact products, and reusing each row's partial sums where
    # every grey value is a whole number, give the term-order chain's bits.
    px = rng.integers(0, 256, size=(4, 66, 130, channels), dtype=np.uint8)
    px[0] = 0
    px[1, ::2] = 255
    for tile in px:
        g = grey_f32(tile, level)
        whole = level == 2 or channels == 1
        np.testing.assert_array_equal(column_magnitude(g, whole), magnitude(g))
        if whole:
            np.testing.assert_array_equal(column_magnitude(g, False), magnitude(g))


def sobel_tile_model(rows: np.ndarray, width: int, channels: int,
                     level: int) -> np.ndarray:
    """(..., H, W*C) uint8 -> the kernel's result, tile by tile."""
    lead = rows.shape[:-2]
    h = rows.shape[-2]
    imgs = rows.reshape(-1, h, width, channels)
    out = np.zeros_like(imgs)
    for b, img in enumerate(imgs):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, width, TILE_W):
                ys = np.clip(np.arange(y0 - 1, y0 + TILE_H + 1), 0, h - 1)
                xs = np.clip(np.arange(x0 - 1, x0 + TILE_W + 1), 0, width - 1)
                mag = column_magnitude(grey_f32(img[ys][:, xs], level),
                                       level == 2 or channels == 1)
                y = np.arange(y0, y0 + TILE_H)[:, None]
                x = np.arange(x0, x0 + TILE_W)[None, :]
                inside = (y >= 1) & (y <= h - 2) & (x >= 1) & (x <= width - 2)
                tile = np.where(inside, mag, 0).astype(np.uint8)
                n, m = min(TILE_H, h - y0), min(TILE_W, width - x0)
                out[b, y0:y0 + n, x0:x0 + m] = tile[:n, :m, None]
    return out.reshape(rows.shape)


SOBEL_SHAPES = [(37, 301, 3), (19, 23, 1), (17, 29, 4), (20, 140, 3), (1, 7, 1),
                (2, 2, 3), (9, 2, 4), (3, 3, 1)]


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("shape", SOBEL_SHAPES)
def test_sobel_tile_model_equals_plain_and_jax(rng, shape, level):
    h, w, c = shape
    rows = _image(rng, h, w, c)
    got = sobel_tile_model(rows, w, c, level)
    plain = sobel.sobel_rows_plain if level == 2 else sobel.sobel_f32_rows_plain
    np.testing.assert_array_equal(got, plain(torch.from_numpy(rows), w, c).numpy())
    want = np.asarray(jax.jit(lambda r: sobel_pallas_rows(
        r, w, c, level=level, interpret=True))(rows))
    assert_sobel_close(got.reshape(h, w, c), want.reshape(h, w, c))
    if c > 1:
        want = np.asarray(jax.jit(lambda r: sobel_mxu_rows(
            r, w, c, level=level, interpret=True))(rows))
        assert_sobel_close(got.reshape(h, w, c), want.reshape(h, w, c))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_sobel_tile_model_on_a_batch(rng, channels):
    # One grey value on a .5 tie that XLA's FMA rounds the other way moves
    # up to 9 pixels, so JAX is held to the tolerance over the whole batch
    # of 3 x 64 x 160 pixels, and the numpy oracle settles each image.
    h, w = 64, 160
    imgs = _image(rng, h, w, channels, lead=(3,))
    got = sobel_tile_model(imgs, w, channels, 2)
    np.testing.assert_array_equal(got, sobel.sobel_rows_plain(
        torch.from_numpy(imgs), w, channels).numpy())
    want = np.asarray(jax.jit(lambda r: sobel_pallas_rows_batch(
        r, w, channels, level=2, interpret=True))(imgs))
    assert_sobel_close(got.reshape(3 * h, w, channels),
                       want.reshape(3 * h, w, channels))
    for i in range(3):
        np.testing.assert_array_equal(got[i], sobel_tile_model(
            imgs[i], w, channels, 2))
        np.testing.assert_array_equal(got[i].reshape(h, w, channels), oracle.sobel(
            imgs[i].reshape(h, w, channels), 2))


# -- the wrappers ------------------------------------------------------------------

@pytest.mark.parametrize("name,fn_name", [
    ("gaussian_rows", "gip_gaussian_rows"),
    ("gaussian_folded_rows", "gip_gaussian_folded_rows")])
def test_gaussian_wrappers_launch_once_without_scratch(monkeypatch, name,
                                                       fn_name):
    # The taps go to the launch as a table to read on the host (they are a
    # kernel parameter, passed by value); the table may lie on the host.
    rows = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    w = weights_to_torch(gaussian_kernel_f32(3, 2.0), CPU)
    with pytest.raises(RuntimeError, match="cuda device"):
        getattr(blur, name)(rows, w, 3, 3)
    launched = []
    monkeypatch.setattr(blur, "_launch", lambda fn, x, *args, **kw:
                        launched.append((fn, args, kw)) or x)
    getattr(blur, name)(rows, w, 3, 3)
    assert len(launched) == 1
    fn, args, kw = launched[0]
    # (channels, radius), no scratch, and the table itself.
    assert (fn, args, list(kw)) == (fn_name, (3, 3), ["taps"]) and kw["taps"] is w


def test_gaussian_table_on_the_host_or_the_rows_device():
    rows = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    blur.check_table(torch.zeros(7), rows, 3, "weights", on_host=True)
    blur.check_table(torch.zeros(7, device="meta"), rows, 3, "weights",
                     on_host=True)
    with pytest.raises(ValueError, match=r"\(7,\) float32 tensor on meta or "
                                         r"the host"):
        blur.check_table(torch.zeros(5), rows, 3, "weights", on_host=True)
    with pytest.raises(ValueError, match="on meta$"):
        blur.check_table(torch.zeros(7), rows, 3, "hi")


@pytest.mark.parametrize("name", ["gaussian_rows", "gaussian_folded_rows"])
def test_gaussian_caps_raise_before_any_launch(name):
    fn = getattr(blur, name)
    rows = torch.empty((4, 33 * 5), dtype=torch.uint8, device="meta")
    w = torch.empty(65, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match=r"gaussian kernel takes r <= 31 and "
                                         r"at most 32 channels; got r = 32"):
        fn(rows, w, 32, 3)
    w = torch.empty(7, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="at most 32 channels; got r = 3, "
                                         "33 channels"):
        fn(rows, w, 3, 33)


@pytest.mark.parametrize("fn", [sobel.sobel_rows, sobel.sobel_f32_rows])
def test_sobel_channel_cap_raises_before_any_launch(fn):
    rows = torch.empty((4, 2 * 5), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match=r"C in \(1, 3, 4\)"):
        fn(rows, 5, 2)


# -- on the card ---------------------------------------------------------------------

CARD_SHAPES = [(37, 301, 3), (20, 700, 1), (33, 150, 4), (1, 7, 1), (2, 2, 3),
               (5, 40, 3)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("radius,sigma", GAUSS + [(20, 8.0)])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_gaussian_kernels_equal_plain_on_card(rng, shape, radius, sigma):
    # r = 20: the weighted kernel that takes its radius at run time.
    dev = _card()
    h, w, c = shape
    table = gaussian_kernel_f32(radius, sigma)
    w_t = weights_to_torch(table, dev)
    w_host = weights_to_torch(table, CPU)
    rows = torch.from_numpy(_image(rng, h, w, c)).to(dev)
    batch = torch.from_numpy(_image(rng, h, w, c, lead=(3,))).to(dev)
    for kernel, plain in ((blur.gaussian_rows, blur.gaussian_rows_plain),
                          (blur.gaussian_folded_rows,
                           blur.gaussian_folded_rows_plain)):
        want = plain(rows, w_t, radius, c)
        assert torch.equal(kernel(rows, w_host, radius, c), want)
        assert torch.equal(kernel(rows, w_t, radius, c), want)
        out = kernel(batch, w_host, radius, c)
        assert torch.equal(out, plain(batch, w_t, radius, c))
        for i in range(3):
            assert torch.equal(out[i], kernel(batch[i].contiguous(), w_host,
                                              radius, c))


@pytest.mark.cuda
def test_gaussian_launches_from_threads_keep_their_own_taps(rng):
    # Threads launch on one stream at once, as the threaded server's
    # requests do: two tables of one kernel (r = 3) and the run-time-radius
    # kernel (r = 20), each launch with its own taps.
    dev = _card()
    rows = torch.from_numpy(_image(rng, 64, 300, 3)).to(dev)
    cases = [(3, 1.0), (3, 2.0), (20, 8.0)]
    outs = {case: [] for case in cases}

    def worker(radius, sigma):
        w = weights_to_torch(gaussian_kernel_f32(radius, sigma), CPU)
        for _ in range(200):
            outs[(radius, sigma)].append(blur.gaussian_rows(rows, w, radius, 3))

    threads = [threading.Thread(target=worker, args=case) for case in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for (radius, sigma), got in outs.items():
        want = blur.gaussian_rows_plain(rows, weights_to_torch(
            gaussian_kernel_f32(radius, sigma), dev), radius, 3)
        assert len(got) == 200
        assert all(torch.equal(g, want) for g in got), (radius, sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES + [(3, 3, 1), (9, 2, 4)])
def test_sobel_kernels_equal_plain_on_card(rng, shape):
    dev = _card()
    h, w, c = shape
    rows = torch.from_numpy(_image(rng, h, w, c)).to(dev)
    batch = torch.from_numpy(_image(rng, h, w, c, lead=(3,))).to(dev)
    for kernel, plain in ((sobel.sobel_rows, sobel.sobel_rows_plain),
                          (sobel.sobel_f32_rows, sobel.sobel_f32_rows_plain)):
        assert torch.equal(kernel(rows, w, c), plain(rows, w, c))
        out = kernel(batch, w, c)
        assert torch.equal(out, plain(batch, w, c))
        for i in range(3):
            assert torch.equal(out[i], kernel(batch[i].contiguous(), w, c))
