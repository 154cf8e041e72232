"""The port's filter models, registry and flagship entry against the JAX
package's.

The JAX side runs as its own tests run it on the CPU: `apply` under
`jax.jit`, its Pallas kernels in interpret mode.  Tolerances: gaussian and
box exact at every level; level-4 registry gaussian within 1 of JAX (the
band's sum order, r >= 3); colour Sobel `assert_sobel_close` (the TPU
kernel's grey value is a contracted multiply-add chain), grey Sobel exact.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

import __graft_entry__
from gpu_image_processing_tpu.core.params import ValidationError as JaxValidationError
from gpu_image_processing_tpu.models import filters as jax_models
from gpu_image_processing_tpu.ops import fused as jax_fused
from gpu_image_processing_tpu_torch.api import filters as api_filters
from gpu_image_processing_tpu_torch.core.params import ValidationError
from gpu_image_processing_tpu_torch.entry import entry
from gpu_image_processing_tpu_torch.models import (
    BoxBlur,
    GaussianBlur,
    SobelEdgeDetection,
    get_filter,
)
from gpu_image_processing_tpu_torch.ops import fused
from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES, blur
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close

SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4)]
CPU = torch.device("cpu")


def _t(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img))


def _jax_apply(model, img: np.ndarray) -> np.ndarray:
    return np.asarray(jax.jit(model.apply)(img))


def _registry(register_all) -> dict:
    impls: dict = {}
    register_all(impls.__setitem__)
    return impls


def _maxdiff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_gaussian_model_matches_jax(rng, shape, level):
    img = make_image(rng, *shape)
    port = GaussianBlur(sigma=2.0, radius=3, level=level)
    tpu = jax_models.GaussianBlur(sigma=2.0, radius=3, level=level)
    got = port(_t(img)).numpy()
    np.testing.assert_array_equal(got, _jax_apply(tpu, img))
    # Every level of `apply` is the reference function, level 4 included:
    # it serves the level-2 function, never the "_adv" one.
    np.testing.assert_array_equal(got, oracle.gaussian_blur(img, tpu.weights, 3))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level,radius", [(1, 3), (2, 3), (4, 3), (2, 40), (4, 40)])
def test_box_model_matches_jax(rng, shape, level, radius):
    img = make_image(rng, *shape)
    got = BoxBlur(radius=radius, level=level)(_t(img)).numpy()
    np.testing.assert_array_equal(
        got, _jax_apply(jax_models.BoxBlur(radius=radius, level=level), img))
    np.testing.assert_array_equal(got, oracle.box_blur(img, radius))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2, 4])
def test_sobel_model_matches_jax(rng, shape, level):
    img = make_image(rng, *shape)
    got = SobelEdgeDetection(level=level)(_t(img)).numpy()
    assert_sobel_close(got, _jax_apply(jax_models.SobelEdgeDetection(level=level), img))
    # Level 4 of `apply` is the level-2 function (quantized grey).
    assert_sobel_close(got, oracle.sobel(img, 1 if level == 1 else 2))
    if level == 4:
        np.testing.assert_array_equal(got, SobelEdgeDetection(level=2)(_t(img)).numpy())


@pytest.mark.parametrize("family,params", [
    ("box", {"radius": 3}), ("sobel", {})])
def test_level_3_is_refused_as_jax(family, params):
    with pytest.raises(JaxValidationError) as want:
        jax_models.get_filter(family, level=3, **params)
    with pytest.raises(ValidationError) as got:
        get_filter(family, level=3, **params)
    assert str(got.value) == str(want.value)


def test_sequential_pipeline_matches_jax(rng):
    # The composition of tests/test_models_profiling.py: blur then edges.
    img = make_image(rng, 16, 18, 3)
    pipeline = nn.Sequential(GaussianBlur(sigma=2.0, radius=3, level=2),
                             SobelEdgeDetection(level=2))
    got = pipeline(_t(img)).numpy()
    blur = jax_models.GaussianBlur(sigma=2.0, radius=3, level=2)
    edge = jax_models.SobelEdgeDetection(level=2)
    want = np.asarray(jax.jit(lambda x: edge.apply(blur.apply(x)))(img))
    assert_sobel_close(got, want)
    assert_sobel_close(got, oracle.sobel(oracle.gaussian_blur(img, blur.weights, 3), 2))


def test_registry_matches_jax(rng):
    port = _registry(fused.register_all)
    tpu = _registry(jax_fused.register_all)
    assert set(port) == set(tpu) == {
        "gaussian", "box", "sobel", "gaussian_adv", "box_adv", "sobel_adv"}
    img = make_image(rng, 21, 26, 3)
    for radius, sigma in ((2, 1.5), (3, 2.0)):
        w = jax_models.GaussianBlur(sigma, radius).weights
        for key in ("gaussian", "gaussian_adv"):
            got = port[key](_t(img), w, radius).numpy()
            want = np.asarray(jax.jit(lambda x, ww, k=key, r=radius: tpu[k](x, ww, r))(img, w))
            # Level 2 and the folded taps exact; the band (r >= 3) within 1.
            assert _maxdiff(got, want) <= (1 if key == "gaussian_adv" and radius >= 3 else 0)
    for key in ("box", "box_adv"):
        np.testing.assert_array_equal(
            port[key](_t(img), 5).numpy(),
            np.asarray(jax.jit(lambda x, k=key: tpu[k](x, 5))(img)))
    for key in ("sobel", "sobel_adv"):
        assert_sobel_close(port[key](_t(img)).numpy(), np.asarray(jax.jit(tpu[key])(img)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_planar_versions_match_jax(rng, shape):
    img = make_image(rng, *shape)
    w = jax_models.GaussianBlur(2.0, 3).weights
    wt = torch.from_numpy(w.copy())
    np.testing.assert_array_equal(
        fused.gaussian_fused(_t(img), wt, 3).numpy(),
        np.asarray(jax.jit(jax_fused.gaussian_fused, static_argnums=2)(img, w, 3)))
    np.testing.assert_array_equal(
        fused.box_fused(_t(img), 4).numpy(),
        np.asarray(jax.jit(jax_fused.box_fused, static_argnums=1)(img, 4)))
    assert_sobel_close(fused.sobel_fused(_t(img)).numpy(),
                       np.asarray(jax.jit(jax_fused.sobel_fused)(img)))
    # The registry's level-2 functions compute the plain ones.
    port = _registry(fused.register_all)
    np.testing.assert_array_equal(port["gaussian"](_t(img), wt, 3).numpy(),
                                  fused.gaussian_fused(_t(img), wt, 3).numpy())
    np.testing.assert_array_equal(port["box"](_t(img), 4).numpy(),
                                  fused.box_fused(_t(img), 4).numpy())
    np.testing.assert_array_equal(port["sobel"](_t(img)).numpy(),
                                  fused.sobel_fused(_t(img)).numpy())


def test_gaussian_weights_buffer():
    port = GaussianBlur(sigma=1.5, radius=4)
    tpu = jax_models.GaussianBlur(sigma=1.5, radius=4)
    np.testing.assert_array_equal(port.weights.numpy(), tpu.weights)
    assert port.weights.dtype == torch.float32
    assert "weights" in port.state_dict()
    assert port.to("meta").weights.device.type == "meta"


def test_gaussian_host_table(rng, monkeypatch):
    # A copy of the buffer on the host, bit for bit, which `.to()` leaves
    # there and `state_dict()` leaves out; forward passes it to the kernel.
    model = GaussianBlur(sigma=1.5, radius=4, level=2)
    assert model.host_weights.device.type == "cpu"
    np.testing.assert_array_equal(model.host_weights.numpy().view(np.uint32),
                                  model.weights.numpy().view(np.uint32))
    assert "host_weights" not in model.state_dict()
    assert set(model.state_dict()) == {"weights"}
    assert model.host_weights is not model.weights
    moved = model.to("meta")
    assert moved.weights.device.type == "meta"
    assert moved.host_weights.device.type == "cpu"
    seen = []
    real = blur.gaussian_rows
    monkeypatch.setattr(blur, "gaussian_rows", lambda rows, w, *a: (
        seen.append(w), real(rows, w, *a))[1])
    model = GaussianBlur(sigma=1.5, radius=4, level=2)
    img = make_image(rng, 11, 13, 3)
    out = model(_t(img))
    assert len(seen) == 1 and seen[0] is model.host_weights
    np.testing.assert_array_equal(out.numpy(), oracle.gaussian_blur(
        img, model.weights.numpy(), 4))
    # Loading a state dict refreshes the host copy.
    other = GaussianBlur(sigma=3.0, radius=4, level=2)
    model.load_state_dict(other.state_dict())
    assert torch.equal(model.host_weights, other.weights)
    assert model.host_weights.device.type == "cpu"


def test_gaussian_forward_takes_the_jax_table(rng):
    img = make_image(rng, 12, 14, 3)
    model = GaussianBlur(sigma=2.0, radius=3, level=2)
    jax_table = jax_models.GaussianBlur(sigma=2.0, radius=3).weights
    np.testing.assert_array_equal(model(_t(img), jax_table).numpy(),
                                  model(_t(img)).numpy())
    # Another table of the same radius changes the result.
    other = jax_models.GaussianBlur(sigma=0.8, radius=3).weights
    assert not np.array_equal(model(_t(img), other).numpy(), model(_t(img)).numpy())


@pytest.mark.parametrize("name,params", [
    ("gaussian", {"sigma": 0.0}), ("gaussian", {"radius": 32}),
    ("gaussian", {"radius": 0}), ("gaussian", {"level": 5}),
    ("box", {"radius": 0}), ("box", {"level": 0}), ("sobel", {"level": 7}),
])
def test_validation_errors_match_jax(name, params):
    with pytest.raises(JaxValidationError) as want:
        jax_models.get_filter(name, **params)
    with pytest.raises(ValidationError) as got:
        get_filter(name, **params)
    assert str(got.value) == str(want.value)


def test_get_filter():
    g = get_filter("gaussian", sigma=3.0, radius=5, level=4)
    assert isinstance(g, GaussianBlur) and (g.sigma, g.radius, g.level) == (3.0, 5, 4)
    assert tuple(g.weights.shape) == (11,)
    assert isinstance(get_filter("box", radius=2), BoxBlur)
    assert isinstance(get_filter("sobel"), SobelEdgeDetection)
    with pytest.raises(ValueError, match="Unknown filter: emboss") as got:
        get_filter("emboss")
    with pytest.raises(ValueError) as want:
        jax_models.get_filter("emboss")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model", [GaussianBlur(2.0, 3, level=1), BoxBlur(2, level=4),
                                   SobelEdgeDetection(level=2)],
                         ids=["gaussian", "box", "sobel"])
def test_run_on_a_cpu_runtime_returns_metrics(rng, model):
    img = make_image(rng, 12, 14, 3)
    out, metrics = model.run(img, runtime=FilterRuntime("cpu"))
    assert out.shape == img.shape and out.dtype == np.uint8
    assert set(metrics) == {"time_ms", "bandwidth_gbps", "fps"}
    assert metrics["time_ms"] > 0 and metrics["fps"] > 0
    np.testing.assert_array_equal(out, model(_t(img)).numpy())


def test_run_goes_through_the_module_runtime(rng, monkeypatch):
    img = make_image(rng, 10, 12, 3)
    monkeypatch.setattr(api_filters, "_runtime", None)
    if not torch.cuda.is_available():
        # The module runtime targets the card unless asked for the CPU.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BoxBlur(2).run(img)
    api_filters.set_device("cpu")
    out, metrics = BoxBlur(2).run(img)
    np.testing.assert_array_equal(out, oracle.box_blur(img, 2))
    assert metrics["time_ms"] > 0


def test_entry_shapes_and_jax_parity():
    forward, (image, weights) = entry("cpu")
    assert tuple(image.shape) == (256, 384, 3) and image.dtype == torch.uint8
    assert tuple(weights.shape) == (7,) and weights.dtype == torch.float32
    before = dict(LAUNCHES)
    out = forward(image, weights)
    assert dict(LAUNCHES) == before
    jax_forward, (jax_img, jax_w) = __graft_entry__.entry()
    np.testing.assert_array_equal(image.numpy(), jax_img)
    np.testing.assert_array_equal(weights.numpy(), jax_w)
    np.testing.assert_array_equal(out.numpy(), oracle.gaussian_blur(jax_img, jax_w, 3))
    # XLA on the CPU contracts the kernel's multiply and add into one
    # rounding, which moves a .5 tie at 2 of the 294,912 bytes of this input.
    want = np.asarray(jax.jit(jax_forward)(jax_img, jax_w))
    assert _maxdiff(out.numpy(), want) <= 1


def test_entry_targets_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


@pytest.mark.cuda
def test_entry_on_card_matches_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    forward, (image, weights) = entry()
    assert image.device.type == "cuda"
    before = dict(LAUNCHES)
    out = forward(image, weights)
    # The (H, W*C) view of the image through the rows kernel, no planar one.
    assert LAUNCHES["gaussian_rows"] == before.get("gaussian_rows", 0) + 1
    assert LAUNCHES["gaussian_planar"] == before.get("gaussian_planar", 0)
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  fused.gaussian_fused(image, weights, 3).cpu().numpy())
