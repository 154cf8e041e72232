"""Each CUDA kernel's plain torch version against the TPU kernel it replaces.

The TPU kernels run as the JAX package's own tests run them on the CPU: in
Pallas interpret mode.  The port's wrappers get CPU tensors, so they serve
their plain versions; the kernels themselves run only on the card
(`cuda`-marked tests here, and chip_smoke.py).

Tolerances: gaussian and box are bit-exact at the suite's fixed sigmas
(their window sums are exact or rounded in the same order).  Grey Sobel is
exact; colour Sobel uses `assert_sobel_close`, because the TPU kernels'
grey value is a contracted multiply-add chain (sobel.py) or a bf16 band
matmul (sobel_mxu.py) where the port rounds every operation.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops.pallas.blur import (
    box_pallas_rows,
    gaussian_pallas_rows,
)
from gpu_image_processing_tpu.ops.pallas.blur_mxu import box_mxu_rows
from gpu_image_processing_tpu.ops.pallas.sobel import sobel_pallas_rows
from gpu_image_processing_tpu.ops.pallas.sobel_mxu import sobel_mxu_rows
from gpu_image_processing_tpu.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES, blur, build, sobel
from gpu_image_processing_tpu_torch.ops.weights import weights_to_torch
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(1, 1.0), (3, 2.0), (5, 2.5)])
def test_gaussian_plain_matches_blur_kernel(rng, shape, radius, sigma):
    img = make_image(rng, *shape)
    c = shape[2]
    w = gaussian_kernel_f32(radius, sigma)
    wt = weights_to_torch(w, CPU)
    got = _port(blur.gaussian_rows_plain, img, wt, radius, c)
    want = _tpu(lambda r, ww: gaussian_pallas_rows(r, ww, radius, c,
                                                   interpret=True), img, w)
    np.testing.assert_array_equal(got, want)
    # A CPU tensor gets the plain version from the wrapper.
    np.testing.assert_array_equal(
        _port(blur.gaussian_rows, img, wt, radius, c), got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [1, 3])
def test_box_plain_matches_blur_kernel(rng, shape, radius):
    img = make_image(rng, *shape)
    c = shape[2]
    got = _port(blur.box_rows_plain, img, radius, c)
    want = _tpu(lambda r: box_pallas_rows(r, radius, c, interpret=True), img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port(blur.box_rows, img, radius, c), got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", [2, 5])
def test_box_plain_matches_mxu_kernel(rng, shape, radius):
    img = make_image(rng, *shape)
    c = shape[2]
    got = _port(blur.box_rows_plain, img, radius, c)
    want = _tpu(lambda r: box_mxu_rows(r, radius, c, interpret=True), img)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_sobel_plain_matches_sobel_kernel(rng, shape):
    img = make_image(rng, *shape)
    h, w, c = shape
    got = _port(sobel.sobel_rows_plain, img, w, c)
    want = _tpu(lambda r: sobel_pallas_rows(r, w, c, level=2, interpret=True),
                img)
    if c == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert_sobel_close(got, want)
    np.testing.assert_array_equal(_port(sobel.sobel_rows, img, w, c), got)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] > 1])
def test_sobel_plain_matches_mxu_kernel(rng, shape):
    img = make_image(rng, *shape)
    h, w, c = shape
    got = _port(sobel.sobel_rows_plain, img, w, c)
    want = _tpu(lambda r: sobel_mxu_rows(r, w, c, level=2, interpret=True), img)
    assert_sobel_close(got, want)


def test_cpu_calls_launch_nothing(rng):
    img = make_image(rng, 8, 9, 3)
    before = dict(LAUNCHES)
    _port(blur.gaussian_rows, img,
          weights_to_torch(gaussian_kernel_f32(3, 2.0), CPU), 3, 3)
    _port(blur.box_rows, img, 4, 3)
    _port(sobel.sobel_rows, img, 9, 3)
    assert dict(LAUNCHES) == before


def test_loader_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.load("blur", torch.device("cuda"), {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FilterRuntime(torch.device("cuda"))


def test_non_cpu_tensor_never_gets_the_plain_version():
    # A tensor off the CPU goes to the loader, which refuses anything but an
    # sm_90 card; it is never served by the plain version.
    rows = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="cuda device"):
        blur.box_rows(rows, 2, 3)
    with pytest.raises(RuntimeError, match="cuda device"):
        sobel.sobel_rows(rows, 4, 3)
    w = torch.empty(7, dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="cuda device"):
        blur.gaussian_rows(rows, w, 3, 3)


def test_wrappers_validate_rows():
    rows = torch.empty((4, 12), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="uint8"):
        blur.box_rows(rows, 2, 3)
    rows = torch.empty((4, 10), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="multiple"):
        sobel.sobel_rows(rows, 3, 3)
    rows = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    w = torch.empty(5, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="weights"):
        blur.gaussian_rows(rows, w, 3, 3)


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    for src in build.SOURCE_DIR.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "SOURCE_DIR", tmp_path)
    key = build._source_hash("blur")
    assert build._source_hash("blur") == key
    with open(tmp_path / "blur.cu", "a") as f:
        f.write("\n// edited\n")
    assert build._source_hash("blur") != key
    assert build._source_hash("sobel") != key
    flags = " ".join(build.NVCC_FLAGS)
    assert "sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 3), (1, 7, 1)])
def test_kernels_match_plain_on_card(rng, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    dev = torch.device("cuda")
    img = make_image(rng, *shape)
    h, w, c = shape
    rows = torch.from_numpy(_rows(img).copy()).to(dev)
    for radius, sigma in [(1, 1.0), (3, 2.0), (15, 8.0), (31, 8.0)]:
        wt = weights_to_torch(gaussian_kernel_f32(radius, sigma), dev)
        assert torch.equal(blur.gaussian_rows(rows, wt, radius, c),
                           blur.gaussian_rows_plain(rows, wt, radius, c))
    # Box: the window kernel in box mode to r = 7, running sums from r = 8.
    for radius in [1, 2, 5, 7, 8, 15, 40]:
        assert torch.equal(blur.box_rows(rows, radius, c),
                           blur.box_rows_plain(rows, radius, c))
    got = sobel.sobel_rows(rows, w, c).cpu().numpy().reshape(h, w, c)
    want = sobel.sobel_rows_plain(rows, w, c).cpu().numpy().reshape(h, w, c)
    assert_sobel_close(got, want)
