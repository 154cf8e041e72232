"""The planar surface of the port: K5 (`blur_planar`), K6 and K7
(`sobel_planar`), the planar registry functions of `ops/cuda/api.py`, and
the level-1 functions of `ops/ref.py`.

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
    sobel_planar,
)
from gpu_image_processing_tpu_torch.ops.weights import weights_to_torch

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close

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


# -- K5: the fused planar blur -----------------------------------------------


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
    # r <= 31: the fused planar blur; above: the two-pass box_rows on the
    # planes.  Both exact, like the MXU box.
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


@pytest.mark.parametrize("radius,sigma,want_fn", [
    (1, 1.0, "gaussian_folded_planar"), (2, 1.5, "gaussian_folded_planar"),
    (3, 2.0, "gaussian_band_rows"), (31, 8.0, "gaussian_band_rows")])
def test_level4_gaussian_routes_on_radius(rng, monkeypatch, radius, sigma,
                                          want_fn):
    img = make_image(rng, 9, 11, 3)
    _, wt = _table(radius, sigma)
    calls = []
    for mod, name in ((blur_planar, "gaussian_folded_planar"),
                      (blur, "gaussian_band_rows"),
                      (blur_planar, "gaussian_planar")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    api.level4_impls()["gaussian"](_t(img), wt, radius)
    assert calls == [want_fn]
    calls.clear()
    api.level2_impls()["gaussian"](_t(img), wt, radius)
    assert calls == ["gaussian_planar"]


@pytest.mark.parametrize("radius,want_fn", [(1, "box_planar"), (31, "box_planar"),
                                            (32, "box_rows"), (40, "box_rows")])
def test_box_routes_on_the_tile_cap(rng, monkeypatch, radius, want_fn):
    img = make_image(rng, 9, 11, 3)
    calls = []
    for mod, name in ((blur_planar, "box_planar"), (blur, "box_rows")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    got = api.level2_impls()["box"](_t(img), radius).numpy()
    assert calls == [want_fn]
    np.testing.assert_array_equal(got, oracle.box_blur(img, radius))


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
    assert {"blur_planar", "sobel_planar"} <= set(build.SOURCES)


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 3), (1, 7, 1), (7, 1, 3)])
def test_planar_kernels_match_plain_on_card(rng, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    dev = torch.device("cuda")
    img = make_image(rng, *shape)
    planes = _planes(img).to(dev)
    for radius, sigma in [(1, 1.0), (2, 1.5), (3, 2.0), (15, 8.0), (31, 8.0)]:
        wt = weights_to_torch(gaussian_kernel_f32(radius, sigma), dev)
        for kernel, plain in ((blur_planar.gaussian_planar,
                               blur_planar.gaussian_planar_plain),
                              (blur_planar.gaussian_folded_planar,
                               blur_planar.gaussian_folded_planar_plain)):
            assert torch.equal(kernel(planes, wt, radius), plain(planes, wt, radius))
        assert torch.equal(blur_planar.box_planar(planes, radius),
                           blur_planar.box_planar_plain(planes, radius))
    for level, kernel in ((2, sobel_planar.sobel_planar),
                          (1, sobel_planar.sobel_f32_planar)):
        for zero_rows in (True, False):
            got = kernel(planes, zero_rows=zero_rows).cpu().permute(1, 2, 0).numpy()
            want = sobel_planar.sobel_planar_plain(
                planes, level, zero_rows=zero_rows).cpu().permute(1, 2, 0).numpy()
            assert_sobel_close(got, want)
