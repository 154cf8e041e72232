"""The planar surface of the port: K5 (`blur_planar`), K6 and K7
(`sobel_planar`), the planar registry functions of `ops/cuda/api.py` (which
run the rows kernels on the (H, W*C) view of an image), and the level-1
functions of `ops/ref.py`; numpy models of the planar kernels' staging (the
halo-row index map and the Sobel's zero row pad).

Each plain version (what the kernel computes, in plain torch ops) against
the TPU kernel it replaces, run as the JAX package's own tests run it on the
CPU: in Pallas interpret mode under `jax.jit`; and against the numpy oracle.
The port's wrappers get CPU tensors, so they serve their plain versions;
the kernels themselves run only on the card (`cuda`-marked tests here, and
chip_smoke.py).

Tolerances: gaussian (weighted and folded) and box are bit-exact against
K5 (the same taps in the same order; box sums are exact); the planar band
(level 4, r >= 3) is within 1 of `gaussian_mxu` (the TPU sums each band
matmul in its own order, the port in tap order) and box against `box_mxu`
is exact.  Grey Sobel is exact; colour Sobel uses `assert_sobel_close`,
because the TPU kernel's grey value is a contracted multiply-add chain where
the port rounds every operation.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops import ref as jax_ref
from gpu_image_processing_tpu.ops.pallas import api as jax_api
from gpu_image_processing_tpu.ops.pallas.blur import (
    _separable_blur_planar,
    box_pallas,
    box_pallas_batch,
    gaussian_pallas,
    gaussian_pallas_batch,
)
from gpu_image_processing_tpu.ops.pallas.blur_mxu import box_mxu, gaussian_mxu
from gpu_image_processing_tpu.ops.pallas.sobel import sobel_pallas, sobel_pallas_batch
from gpu_image_processing_tpu.ops.weights import (
    box_inv_taps_f32,
    gaussian_kernel_f32,
)
from gpu_image_processing_tpu_torch.core.config import MAX_KERNEL_TAPS
from gpu_image_processing_tpu_torch.ops import ref
from gpu_image_processing_tpu_torch.ops.cuda import (
    LAUNCHES,
    api,
    blur,
    blur_planar,
    build,
    sobel,
    sobel_planar,
)
from gpu_image_processing_tpu_torch.ops.weights import weights_to_torch

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close
from .test_torch_rows_redesign import grey_f32, magnitude

SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4)]
CPU = torch.device("cpu")
# A row band [A, B) of a BAND_SHAPE image, with its neighbour rows as halo.
BAND_SHAPE, A, B = (40, 33, 3), 10, 25


def _t(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img))


def _planes(img: np.ndarray) -> torch.Tensor:
    return _t(img.transpose(2, 0, 1))


def _hwc(planes: torch.Tensor) -> np.ndarray:
    return planes.permute(1, 2, 0).numpy()


def _jit(fn, *args) -> np.ndarray:
    return np.asarray(jax.jit(fn)(*args))


def _maxdiff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _table(radius, sigma):
    w = gaussian_kernel_f32(radius, sigma)
    return w, weights_to_torch(w, CPU)


# -- K5: the planar blur -----------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (2, 1.5), (3, 2.0)])
@pytest.mark.parametrize("folded", [False, True])
def test_gaussian_planar_plain_matches_blur_kernel(rng, shape, radius, sigma,
                                                   folded):
    img = make_image(rng, *shape)
    w, wt = _table(radius, sigma)
    plain = (blur_planar.gaussian_folded_planar_plain if folded
             else blur_planar.gaussian_planar_plain)
    got = _hwc(plain(_planes(img), wt, radius))
    want = _jit(lambda x, ww: gaussian_pallas(
        x, ww, radius, interpret=True, folded=folded), img, w)
    np.testing.assert_array_equal(got, want)
    level2 = oracle.gaussian_blur(img, w, radius)
    if folded:
        assert _maxdiff(got, level2) <= 1
    else:
        np.testing.assert_array_equal(got, level2)
    # The wrapper serves the plain version on the CPU.
    wrapper = (blur_planar.gaussian_folded_planar if folded
               else blur_planar.gaussian_planar)
    np.testing.assert_array_equal(_hwc(wrapper(_planes(img), wt, radius)), got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 5, 31])
def test_box_planar_plain_matches_blur_kernel(rng, shape, radius):
    img = make_image(rng, *shape)
    got = _hwc(blur_planar.box_planar_plain(_planes(img), radius))
    want = _jit(lambda x: box_pallas(x, radius, interpret=True), img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.box_blur(img, radius))
    np.testing.assert_array_equal(_hwc(blur_planar.box_planar(_planes(img), radius)),
                                  got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [2, 40])
def test_planar_box_route_matches_box_mxu(rng, shape, radius):
    # box_rows on the (H, W*C) view at every radius (one launch to r = 64,
    # two past it).  Exact, like the MXU box.
    img = make_image(rng, *shape)
    got = api.level2_impls()["box"](_t(img), radius).numpy()
    want = _jit(lambda x: box_mxu(x, radius, interpret=True), img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(api.level4_impls()["box"](_t(img), radius).numpy(),
                                  got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(3, 2.0), (5, 2.5), (15, 8.0)])
def test_planar_band_matches_gaussian_mxu(rng, shape, radius, sigma):
    img = make_image(rng, *shape)
    w, wt = _table(radius, sigma)
    got = api.level4_impls()["gaussian"](_t(img), wt, radius).numpy()
    want = _jit(lambda x, ww: gaussian_mxu(x, ww, radius, interpret=True), img, w)
    assert _maxdiff(got, want) <= 1
    assert _maxdiff(got, oracle.gaussian_blur(img, w, radius)) <= 1


def test_gaussian_planar_rows_prepadded_matches_jax_band():
    rng = np.random.default_rng(7)
    img = make_image(rng, *BAND_SHAPE)
    radius = 3
    w, wt = _table(radius, 2.0)
    band = img[A - radius:B + radius]
    got = _hwc(blur_planar.gaussian_planar(_planes(band), wt, radius,
                                           rows_prepadded=True))
    want = _jit(lambda x, ww: _separable_blur_planar(
        x, ww, radius, box_mode=False, interpret=True, rows_prepadded=True),
        band.transpose(2, 0, 1), w).transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)
    whole = np.asarray(jax.jit(jax_ref.gaussian_blur, static_argnums=2)(img, w, radius))
    np.testing.assert_array_equal(got, whole[A:B])
    np.testing.assert_array_equal(got, ref.gaussian_blur(_t(img), wt, radius)[A:B].numpy())


@pytest.mark.parametrize("radius", [2, 5])
def test_box_and_folded_planar_rows_prepadded(radius):
    rng = np.random.default_rng(8)
    img = make_image(rng, *BAND_SHAPE)
    band = _planes(img[A - radius:B + radius])
    inv = np.full(2 * radius + 1, box_inv_taps_f32(radius), np.float32)
    got = _hwc(blur_planar.box_planar(band, radius, rows_prepadded=True))
    want = _jit(lambda x, ww: _separable_blur_planar(
        x, ww, radius, box_mode=True, interpret=True, rows_prepadded=True),
        img[A - radius:B + radius].transpose(2, 0, 1), inv).transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle.box_blur(img, radius)[A:B])
    # Folded taps: a band equals the same rows of the whole image.
    _, wt = _table(radius, 1.5)
    whole = blur_planar.gaussian_folded_planar(_planes(img), wt, radius)
    np.testing.assert_array_equal(
        blur_planar.gaussian_folded_planar(band, wt, radius, rows_prepadded=True),
        whole[:, A:B])


# The halo-row index map of the window kernels' staging (launch.cuh
# stage_rows): `src` points at an image's input row `halo`, and virtual row v
# (output row y reads v = y - r .. y + r) is staged from input row
# halo + clamp(v, -halo, height + halo - 1).  halo = 0 is an image alone
# (clamped at its edges); halo = r reads the given halo rows unclamped.

F32 = np.float32


def staged_row(v: np.ndarray, height: int, halo: int) -> np.ndarray:
    return halo + np.clip(v, -halo, height + halo - 1)


def _taps_sum(x, table: np.ndarray, radius: int, mode: str) -> np.ndarray:
    """One pass over the taps x(0) .. x(2r) (f32), in the mode's order."""
    if mode == "box":
        acc = x(0)
        for t in range(1, 2 * radius + 1):
            acc = (acc + x(t)).astype(F32)
        return (acc * box_inv_taps_f32(radius)).astype(F32)
    if mode == "folded":
        acc = None
        for t in range(radius):
            term = ((x(t) + x(2 * radius - t)) * table[t]).astype(F32)
            acc = term if acc is None else (acc + term).astype(F32)
        mid = (x(radius) * table[radius]).astype(F32)
        return mid if acc is None else (acc + mid).astype(F32)
    acc = (x(0) * table[0]).astype(F32)
    for t in range(1, 2 * radius + 1):
        acc = (acc + (x(t) * table[t]).astype(F32)).astype(F32)
    return acc


def _q(x: np.ndarray) -> np.ndarray:
    return np.clip(np.floor((x + F32(0.5)).astype(F32)), 0, 255).astype(F32)


def halo_model(planes: np.ndarray, table: np.ndarray, radius: int, mode: str,
               halo: int) -> np.ndarray:
    """(N, H + 2 halo, W) u8 planes -> (N, H, W): the separable blur with
    its vertical taps read through the staging's row map."""
    _, rows, w = planes.shape
    h = rows - 2 * halo
    staged = planes[:, staged_row(np.arange(-radius, h + radius), h, halo)]
    x = staged[:, :, np.clip(np.arange(-radius, w + radius), 0, w - 1)].astype(F32)
    horiz = _q(_taps_sum(lambda t: x[:, :, t:t + w], table, radius, mode))
    return _q(_taps_sum(lambda t: horiz[:, t:t + h], table, radius,
                        mode)).astype(np.uint8)


PLAIN_K5 = {"gaussian": blur_planar.gaussian_planar_plain,
            "folded": blur_planar.gaussian_folded_planar_plain,
            "box": lambda p, w, r, pre=False: blur_planar.box_planar_plain(p, r, pre)}


@pytest.mark.parametrize("mode,radius", [
    ("gaussian", 1), ("gaussian", 3), ("gaussian", 15), ("gaussian", 31),
    ("folded", 1), ("folded", 2), ("box", 1), ("box", 5), ("box", 31)])
def test_halo_row_map_gives_the_whole_image_rows(rng, mode, radius):
    h, w = 40, 37
    planes = rng.integers(0, 256, size=(2, h, w), dtype=np.uint8)
    table, wt = _table(radius, 8.0 if radius > 3 else 1.5)
    plain = PLAIN_K5[mode]
    whole = halo_model(planes, table, radius, mode, 0)
    np.testing.assert_array_equal(
        whole, plain(torch.from_numpy(planes), wt, radius).numpy())
    # A band [a, b) with its neighbour rows as halo; past the image's edge
    # they are the edge rows, as the whole image's clamp reads them.
    for a, b in ((10, 25), (0, 12), (30, 40), (0, 40), (19, 20)):
        band = np.ascontiguousarray(
            planes[:, np.clip(np.arange(a - radius, b + radius), 0, h - 1)])
        got = halo_model(band, table, radius, mode, radius)
        np.testing.assert_array_equal(got, whole[:, a:b])
        np.testing.assert_array_equal(
            got, plain(torch.from_numpy(band), wt, radius, True).numpy())
    # The kernels stage up to a chunk of 16 rows past the last output row's
    # window: with halo rows those still lie in the input.
    v = np.arange(-radius, h + radius + 16)
    assert staged_row(v, h, radius).min() == 0
    assert staged_row(v, h, radius).max() == h + 2 * radius - 1


# -- K6 and K7: planar Sobel ------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_planar_plain_matches_sobel_kernel(rng, shape, level):
    img = make_image(rng, *shape)
    got = _hwc(sobel_planar.sobel_planar_plain(_planes(img), level))
    want = _jit(lambda x: sobel_pallas(x, level=level, interpret=True), img)
    assert_sobel_close(got, want)
    assert_sobel_close(got, oracle.sobel(img, level))
    wrapper = sobel_planar.sobel_planar if level == 2 else sobel_planar.sobel_f32_planar
    np.testing.assert_array_equal(_hwc(wrapper(_planes(img))), got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_planar_batch_matches_batch_kernel(rng, shape, level):
    imgs = np.stack([make_image(rng, *shape) for _ in range(2)])
    got = api.sobel_planar_batch(_t(imgs), level).numpy()
    want = _jit(lambda x: sobel_pallas_batch(x, level=level, interpret=True), imgs)
    for i in range(2):
        assert_sobel_close(got[i], want[i])
        # One launch over the batch equals each image on its own.
        np.testing.assert_array_equal(
            got[i], _hwc(sobel_planar.sobel_planar_plain(_planes(imgs[i]), level)))


@pytest.mark.parametrize("level", [1, 2])
def test_sobel_planar_rows_prepadded_band_matches_jax(level):
    rng = np.random.default_rng(9)
    img = make_image(rng, *BAND_SHAPE)
    band = img[None, A - 1:B + 1]
    got = api.sobel_planar_batch(_t(band), level, rows_prepadded=True,
                                 zero_rows=False).numpy()
    want = _jit(lambda x: sobel_pallas_batch(
        x, level=level, interpret=True, rows_prepadded=True, zero_rows=False),
        band)
    np.testing.assert_array_equal(got, want)
    whole = np.asarray(jax.jit(jax_ref.sobel, static_argnums=1)(img, level))
    np.testing.assert_array_equal(got[0], whole[A:B])
    np.testing.assert_array_equal(got[0], ref.sobel(_t(img), level)[A:B].numpy())


def sobel_planar_model(planes: np.ndarray, level: int, halo: int,
                       zero_rows: bool) -> np.ndarray:
    """(B, C, H + 2 halo, W) u8 -> (B, C, H, W): the planar Sobel tile's
    function, its grey rows staged through the row map and 0 outside the
    image and its halo rows (the TPU kernels' constant row pad), not
    clamped."""
    b, c, rows, w = planes.shape
    h = rows - 2 * halo
    v = np.arange(-1, h + 1)
    g = grey_f32(np.moveaxis(planes[:, :, staged_row(v, h, halo)], 1, -1), level)
    g[:, (v < -halo) | (v >= h + halo)] = 0
    g = g[:, :, np.clip(np.arange(-1, w + 1), 0, w - 1)]
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    inside = (x >= 1) & (x <= w - 2)
    if zero_rows:
        inside = inside & (y >= 1) & (y <= h - 2)
    mag = np.stack([np.where(inside, magnitude(gi), 0) for gi in g])
    return np.repeat(mag[:, None].astype(np.uint8), c, axis=1)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_planar_staging_model_equals_plain(rng, channels, level):
    planes = rng.integers(0, 256, size=(2, channels, 14, 19), dtype=np.uint8)
    for halo, zero_rows in ((0, True), (0, False), (1, True), (1, False)):
        got = sobel_planar_model(planes, level, halo, zero_rows)
        want = sobel_planar.sobel_planar_plain(
            torch.from_numpy(planes), level, halo == 1, zero_rows).numpy()
        np.testing.assert_array_equal(got, want)
    # Rows 3 .. 10 with their halo rows equal those rows of the whole image.
    band = np.ascontiguousarray(planes[:, :, 2:12])
    np.testing.assert_array_equal(
        sobel_planar_model(band, level, 1, False),
        sobel_planar_model(planes, level, 0, True)[:, :, 3:11])


def test_sobel_planar_keeps_rows_without_halo_as_jax():
    # zero_rows=False without halo rows: the rows outside the image read
    # grey 0, as the TPU kernel's constant row pad.
    rng = np.random.default_rng(10)
    imgs = np.stack([make_image(rng, 12, 15, 3), make_image(rng, 12, 15, 3)])
    got = api.sobel_planar_batch(_t(imgs), 2, zero_rows=False).numpy()
    want = _jit(lambda x: sobel_pallas_batch(x, level=2, interpret=True,
                                             zero_rows=False), imgs)
    np.testing.assert_array_equal(got, want)
    assert got[:, 0, 1:-1].any() and got[:, -1, 1:-1].any()


# -- the planar registry and batches ----------------------------------------


def test_registry_keys_and_signatures_match_jax():
    assert set(api.level2_impls()) == set(jax_api.level2_impls())
    assert set(api.level4_impls()) == set(jax_api.level4_impls())


@pytest.mark.parametrize("shape", SHAPES)
def test_level2_impls_match_jax(rng, shape):
    img = make_image(rng, *shape)
    w, wt = _table(3, 2.0)
    port, tpu = api.level2_impls(), jax_api.level2_impls()
    np.testing.assert_array_equal(
        port["gaussian"](_t(img), wt, 3).numpy(),
        _jit(lambda x, ww: tpu["gaussian"](x, ww, 3), img, w))
    # The JAX model's numpy table is taken as it is.
    np.testing.assert_array_equal(port["gaussian"](_t(img), w, 3).numpy(),
                                  port["gaussian"](_t(img), wt, 3).numpy())
    np.testing.assert_array_equal(port["box"](_t(img), 5).numpy(),
                                  _jit(lambda x: tpu["box"](x, 5), img))
    assert_sobel_close(port["sobel"](_t(img)).numpy(), _jit(tpu["sobel"], img))


def _record(monkeypatch, calls, *targets):
    """Record the name and first argument of each call of `targets`, (module,
    name) pairs, and run the function."""
    for mod, name in targets:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append((_n, tuple(a[0].shape))), _fn(*a, **k))[1])


GAUSS_FNS = ((blur, "gaussian_rows"), (blur, "gaussian_folded_rows"),
             (blur, "gaussian_band_rows"), (blur_planar, "gaussian_planar"),
             (blur_planar, "gaussian_folded_planar"))


@pytest.mark.parametrize("radius,sigma,want_fn", [
    (1, 1.0, "gaussian_folded_planar"), (2, 1.5, "gaussian_folded_planar"),
    (3, 2.0, "gaussian_band_rows"), (31, 8.0, "gaussian_band_rows")])
def test_level4_gaussian_routes_on_radius(rng, monkeypatch, radius, sigma,
                                          want_fn):
    # want_fn: the route of an image past the rows kernels' channel cap.
    # Within it, the weighted and folded taps run the rows kernels on the
    # (H, W*C) view; the band (r >= 3) runs on the planes, one channel.
    _, wt = _table(radius, sigma)
    calls = []
    _record(monkeypatch, calls, *GAUSS_FNS)
    for c in (3, blur.GAUSS_MAX_CHANNELS + 1):
        img = make_image(rng, 9, 11, c)
        planar = c > blur.GAUSS_MAX_CHANNELS
        want_l4 = want_fn if planar or radius >= 3 else "gaussian_folded_rows"
        got = api.level4_impls()["gaussian"](_t(img), wt, radius).numpy()
        assert [n for n, _ in calls] == [want_l4]
        if radius < 3:
            np.testing.assert_array_equal(
                got, _hwc(blur_planar.gaussian_folded_planar_plain(
                    _planes(img), wt, radius)))
        calls.clear()
        got = api.level2_impls()["gaussian"](_t(img), wt, radius).numpy()
        assert calls == [("gaussian_planar", (c, 9, 11)) if planar
                         else ("gaussian_rows", (9, 11 * c))]
        np.testing.assert_array_equal(
            got, oracle.gaussian_blur(img, wt.numpy(), radius))
        calls.clear()


@pytest.mark.parametrize("radius,want_fn", [(1, "box_planar"), (31, "box_planar"),
                                            (32, "box_rows"), (40, "box_rows")])
def test_box_routes_on_the_tile_cap(rng, monkeypatch, radius, want_fn):
    # want_fn: the route on the planes of an image past box_rows's channel
    # cap, the planar blur's cap (2r + 1 <= MAX_KERNEL_TAPS) deciding; within the channel
    # cap, box_rows on the (H, W*C) view at every radius.
    calls = []
    _record(monkeypatch, calls, (blur_planar, "box_planar"), (blur, "box_rows"))
    for c in (3, blur.BOX_MAX_CHANNELS + 1):
        img = make_image(rng, 9, 11, c)
        got = api.level2_impls()["box"](_t(img), radius).numpy()
        if c > blur.BOX_MAX_CHANNELS:
            assert calls == [(want_fn, (c, 9, 11))]
        else:
            assert calls == [("box_rows", (9, 11 * c))]
        np.testing.assert_array_equal(got, oracle.box_blur(img, radius))
        calls.clear()


def test_tier_runs_the_rows_kernels_without_permutes(rng, monkeypatch):
    # Every call but the level-4 band and the halo modes: the rows function
    # on the contiguous (H, W*C) or (B, H, W*C) view, no permute.
    def refuse(*_args, **_kwargs):
        raise AssertionError("the tier permuted an image")

    monkeypatch.setattr(api, "to_planes", refuse)
    monkeypatch.setattr(api, "from_planes", refuse)
    calls = []
    _record(monkeypatch, calls, *GAUSS_FNS, (blur, "box_rows"),
            (blur_planar, "box_planar"), (sobel, "sobel_rows"),
            (sobel, "sobel_f32_rows"), (sobel_planar, "sobel_planar"),
            (sobel_planar, "sobel_f32_planar"))
    h, w, c = 13, 17, 3
    img = _t(make_image(rng, h, w, c))
    imgs = _t(np.stack([make_image(rng, h, w, c) for _ in range(2)]))
    _, w3 = _table(3, 2.0)
    _, w2 = _table(2, 1.5)
    l2, l4 = api.level2_impls(), api.level4_impls()
    cases = [
        (lambda: l2["gaussian"](img, w3, 3), "gaussian_rows"),
        (lambda: l4["gaussian"](img, w2, 2), "gaussian_folded_rows"),
        (lambda: l2["box"](img, 5), "box_rows"),
        (lambda: l4["box"](img, 40), "box_rows"),
        (lambda: l2["sobel"](img), "sobel_rows"),
        (lambda: l4["sobel"](img), "sobel_f32_rows"),
        (lambda: api.gaussian_planar_batch(imgs, w3, 3), "gaussian_rows"),
        (lambda: api.gaussian_planar_batch(imgs, w2, 2, folded=True),
         "gaussian_folded_rows"),
        (lambda: api.box_planar_batch(imgs, 3), "box_rows"),
        (lambda: api.sobel_planar_batch(imgs, 2), "sobel_rows"),
        (lambda: api.sobel_planar_batch(imgs, 1), "sobel_f32_rows"),
    ]
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "permute", refuse)
        for call, want in cases:
            out = call()
            batch = out.dim() == 4
            assert calls == [(want, (2, h, w * c) if batch else (h, w * c))]
            assert tuple(out.shape) == ((2, h, w, c) if batch else (h, w, c))
            calls.clear()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("folded", [False, True])
def test_gaussian_planar_batch_matches_batch_kernel(rng, shape, folded):
    imgs = np.stack([make_image(rng, *shape) for _ in range(2)])
    w, wt = _table(2, 1.5)
    got = api.gaussian_planar_batch(_t(imgs), wt, 2, folded=folded).numpy()
    want = _jit(lambda x, ww: gaussian_pallas_batch(
        x, ww, 2, interpret=True, folded=folded), imgs, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_box_planar_batch_matches_batch_kernel(rng, shape):
    imgs = np.stack([make_image(rng, *shape) for _ in range(2)])
    got = api.box_planar_batch(_t(imgs), 3).numpy()
    want = _jit(lambda x: box_pallas_batch(x, 3, interpret=True), imgs)
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(got[i], oracle.box_blur(imgs[i], 3))


# -- ops/ref.py ---------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES + [(1, 7, 1), (6, 1, 3)])
def test_ref_matches_jax_ref(rng, shape):
    img = make_image(rng, *shape)
    w, wt = _table(3, 2.0)
    np.testing.assert_array_equal(
        ref.gaussian_blur(_t(img), wt, 3).numpy(),
        np.asarray(jax.jit(jax_ref.gaussian_blur, static_argnums=2)(img, w, 3)))
    np.testing.assert_array_equal(
        ref.box_blur(_t(img), 4).numpy(),
        np.asarray(jax.jit(jax_ref.box_blur, static_argnums=1)(img, 4)))
    gray = ref.grayscale_f32(_t(img))
    assert gray.dtype == torch.float32 and tuple(gray.shape) == shape[:2]
    np.testing.assert_array_equal(
        ref.sobel_magnitude_u8(gray).numpy(),
        np.asarray(jax.jit(jax_ref.sobel_magnitude_u8)(np.asarray(gray))))
    for level in (1, 2):
        assert_sobel_close(ref.sobel(_t(img), level).numpy(),
                           np.asarray(jax.jit(jax_ref.sobel, static_argnums=1)(img, level)))
        assert_sobel_close(ref.sobel(_t(img), level).numpy(), oracle.sobel(img, level))
    np.testing.assert_array_equal(ref.gaussian_blur(_t(img), wt, 3).numpy(),
                                  oracle.gaussian_blur(img, w, 3))


def test_ref_grayscale_matches_jax_on_colour(rng):
    # Each product and sum rounded, as numpy does in float32; XLA contracts
    # the jitted JAX version into multiply-adds, a few ulps apart.
    img = make_image(rng, 13, 17, 4)
    got = ref.grayscale_f32(_t(img)).numpy()
    x = img.astype(np.float32)
    want = (np.float32(0.299) * x[..., 0] + np.float32(0.587) * x[..., 1]
            + np.float32(0.114) * x[..., 2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jax_ref.grayscale_f32)(img)),
                               rtol=1e-6)


# -- the wrappers --------------------------------------------------------------


def test_cpu_planar_calls_launch_nothing(rng):
    img = make_image(rng, 8, 9, 3)
    _, wt = _table(2, 1.5)
    before = dict(LAUNCHES)
    blur_planar.gaussian_planar(_planes(img), wt, 2)
    blur_planar.gaussian_folded_planar(_planes(img), wt, 2)
    blur_planar.box_planar(_planes(img), 2)
    sobel_planar.sobel_planar(_planes(img))
    sobel_planar.sobel_f32_planar(_planes(img))
    for fns in (api.level2_impls(), api.level4_impls()):
        fns["gaussian"](_t(img), wt, 2)
        fns["box"](_t(img), 2)
        fns["sobel"](_t(img))
    assert dict(LAUNCHES) == before


def test_planar_wrappers_never_serve_plain_off_the_cpu():
    planes = torch.empty((3, 8, 12), dtype=torch.uint8, device="meta")
    w = torch.empty(7, dtype=torch.float32, device="meta")
    for call in (lambda: blur_planar.gaussian_planar(planes, w, 3),
                 lambda: blur_planar.gaussian_folded_planar(planes, w, 3),
                 lambda: blur_planar.box_planar(planes, 3),
                 lambda: sobel_planar.sobel_planar(planes),
                 lambda: sobel_planar.sobel_f32_planar(planes)):
        with pytest.raises(RuntimeError, match="cuda device"):
            call()


@pytest.mark.parametrize("call,match", [
    (lambda p, w: blur_planar.box_planar(p, 32), "MAX_KERNEL_TAPS"),
    (lambda p, w: blur_planar.gaussian_planar(p, w, 32), "MAX_KERNEL_TAPS"),
    (lambda p, w: blur_planar.box_planar(p, 0), "radius"),
    (lambda p, w: blur_planar.box_planar(p.float(), 2), "uint8"),
    (lambda p, w: blur_planar.box_planar(p[0], 2), r"\(N, H, W\)"),
    (lambda p, w: blur_planar.box_planar(p, 5, rows_prepadded=True), "no output"),
    (lambda p, w: blur_planar.gaussian_planar(p, w[:5], 3), "weights"),
    (lambda p, w: sobel_planar.sobel_planar(p[:2]), "channels"),
    (lambda p, w: sobel_planar.sobel_planar(p[:, :2].contiguous(),
                                           rows_prepadded=True),
     "no output"),
    (lambda p, w: sobel_planar.sobel_planar(p.transpose(1, 2)), "contiguous"),
])
def test_planar_wrappers_validate(call, match):
    for device in (CPU, torch.device("meta")):
        planes = torch.zeros((3, 8, 12), dtype=torch.uint8, device=device)
        w = torch.zeros(7, dtype=torch.float32, device=device)
        with pytest.raises(ValueError, match=match):
            call(planes, w)


def test_planar_cap_is_the_weight_table_cap():
    assert MAX_KERNEL_TAPS == 64
    assert blur.GAUSS_MAX_RADIUS == (MAX_KERNEL_TAPS - 1) // 2
    # The planar kernels are the rows templates: blur.cu and sobel.cu build
    # them, and no other library does.
    assert set(build.SOURCES) == {"blur", "sobel", "png_unfilter"}


# -- on the card ---------------------------------------------------------------


def _band(planes: torch.Tensor, radius: int) -> tuple[torch.Tensor, int, int]:
    """(rows [a, b) of (..., H, W) planes with `radius` halo rows, replicated
    past the planes' edges, a, b)."""
    h = planes.shape[-2]
    a, b = h // 3, max(h // 3 + 1, 2 * h // 3)
    rows = torch.arange(a - radius, b + radius).clamp(0, h - 1).to(planes.device)
    return planes.index_select(-2, rows).contiguous(), a, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 3), (1, 7, 1), (7, 1, 3),
                                            (5, 13, 3), (33, 517, 1)])
def test_planar_kernels_match_plain_on_card(rng, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    dev = torch.device("cuda")
    img = make_image(rng, *shape)
    planes = _planes(img).to(dev)
    # A batch of planes, each blurred on its own.
    batch = torch.cat([planes, planes.flip(-1), 255 - planes]).contiguous()
    for radius, sigma in [(1, 1.0), (2, 1.5), (3, 2.0), (5, 2.5), (15, 8.0),
                          (20, 8.0), (31, 8.0)]:
        wt = weights_to_torch(gaussian_kernel_f32(radius, sigma), dev)
        pairs = [(blur_planar.gaussian_planar, blur_planar.gaussian_planar_plain)]
        if radius <= 2:
            pairs.append((blur_planar.gaussian_folded_planar,
                          blur_planar.gaussian_folded_planar_plain))
        if radius in (1, 5, 31):
            pairs.append((lambda p, w, r, pre=False: blur_planar.box_planar(p, r, pre),
                          lambda p, w, r, pre=False: blur_planar.box_planar_plain(p, r, pre)))
        for kernel, plain in pairs:
            for p in (planes, batch):
                whole = kernel(p, wt.cpu(), radius)
                assert torch.equal(whole, plain(p, wt, radius))
                assert torch.equal(kernel(p, wt, radius), whole)   # card table
                band, a, b = _band(p, radius)
                got = kernel(band, wt.cpu(), radius, True)
                assert torch.equal(got, plain(band, wt, radius, True))
                assert torch.equal(got, whole[:, a:b])
    for level, kernel in ((2, sobel_planar.sobel_planar),
                          (1, sobel_planar.sobel_f32_planar)):
        for p in (planes, batch.view(3, *planes.shape)):
            band, a, b = _band(p, 1)
            for x, pre in ((p, False), (band, True)):
                for zero_rows in (True, False):
                    got = kernel(x, pre, zero_rows)
                    want = sobel_planar.sobel_planar_plain(x, level, pre, zero_rows)
                    if level == 2 and shape[-1] > 1:
                        g = got.movedim(-3, -1).reshape(-1, *got.shape[-2:], shape[-1])
                        wn = want.movedim(-3, -1).reshape(g.shape)
                        assert_sobel_close(g.cpu().numpy(), wn.cpu().numpy())
                    else:
                        assert torch.equal(got, want)
            if a >= 1 and b <= p.shape[-2] - 1:   # rows the whole image keeps
                assert torch.equal(kernel(band, True, False), kernel(p)[..., a:b, :])


@pytest.mark.cuda
def test_tier_launches_the_rows_kernels_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    dev = torch.device("cuda")
    img = _t(make_image(rng, 37, 301, 3)).to(dev)
    imgs = torch.stack([img, 255 - img])
    _, w3 = _table(3, 2.0)
    _, w2 = _table(2, 1.5)
    l2, l4 = api.level2_impls(), api.level4_impls()
    before = dict(LAUNCHES)
    l2["gaussian"](img, w3, 3)
    l4["gaussian"](img, w2, 2)
    l2["box"](img, 5)
    l2["sobel"](img)
    l4["sobel"](img)
    api.gaussian_planar_batch(imgs, w3, 3)
    api.box_planar_batch(imgs, 5)
    api.sobel_planar_batch(imgs, 2)
    delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
    assert {k: n for k, n in delta.items() if n} == {
        "gaussian_rows": 2, "gaussian_folded_rows": 1, "box_rows": 2,
        "sobel_rows": 2, "sobel_f32_rows": 1}
    # The halo and zero_rows=False batches and the band stay on planes.
    before = dict(LAUNCHES)
    api.sobel_planar_batch(imgs, 2, zero_rows=False)
    api.sobel_planar_batch(imgs[:, :12].contiguous(), 1, rows_prepadded=True)
    l4["gaussian"](img, w3, 3)
    delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
    assert {k: n for k, n in delta.items() if n} == {
        "sobel_planar": 1, "sobel_f32_planar": 1, "gaussian_band_rows": 1}
