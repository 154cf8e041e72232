"""The slice as a whole: the port's API and runtime against the JAX package's.

Same seeded numpy images through `gpu_image_processing_tpu.api.filters`
(JAX on the CPU, level 2 through the Pallas kernels in interpret mode) and
`gpu_image_processing_tpu_torch.api.filters` (torch on the CPU).  Gaussian
and box are bit-exact at the API defaults (sigma 2.0, radius 3) and at the
fixed radii below; Sobel uses `assert_sobel_close` (FMA contraction of the
grey chain on the JAX side; exact for grey images).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.api import filters as jax_api
from gpu_image_processing_tpu.runtime.dispatch import RUNTIME as JAX_RUNTIME
from gpu_image_processing_tpu.runtime.dispatch import FusionUnavailable
from gpu_image_processing_tpu_torch.api import filters as api
from gpu_image_processing_tpu_torch.runtime import timing
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

from .conftest import make_image
from .sobel_tolerance import assert_sobel_close


@pytest.fixture(autouse=True)
def cpu_module_runtime(monkeypatch):
    """The API's module runtime on the CPU, as a caller asks for it; each
    test starts from it and leaves the module as it found it."""
    monkeypatch.setattr(api, "_runtime", FilterRuntime("cpu"))

SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4)]
KEYS = {"image", "time_ms", "bandwidth_gbps", "fps"}
CALLS = {
    "gaussian": lambda mod, img, lv: mod.gaussian_blur(img, 2.0, 3, lv),
    "box": lambda mod, img, lv: mod.box_blur(img, 5, lv),
    "sobel": lambda mod, img, lv: mod.sobel_edge_detection(img, lv),
}


def _assert_filter_close(name, got, want):
    if name == "sobel":
        assert_sobel_close(got, want)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CALLS))
@pytest.mark.parametrize("level", [1, 2])
def test_api_matches_jax(rng, shape, name, level):
    img = make_image(rng, *shape)
    keep = img.copy()
    got = CALLS[name](api, img, level)
    want = CALLS[name](jax_api, img, level)
    assert set(got) == set(want) == KEYS
    assert got["image"].shape == img.shape and got["image"].dtype == np.uint8
    assert all(got[k] > 0 for k in KEYS - {"image"})
    _assert_filter_close(name, got["image"], want["image"])
    np.testing.assert_array_equal(img, keep)


def test_constants_and_defaults(rng):
    assert (api.NAIVE, api.SHARED_MEMORY, api.TEXTURE_MEMORY) == (1, 2, 3)
    img = make_image(rng, 8, 8, 3)
    np.testing.assert_array_equal(api.gaussian_blur(img)["image"],
                                  api.gaussian_blur(img, 2.0, 3, 1)["image"])
    np.testing.assert_array_equal(
        api.gaussian_blur(img, level=api.TEXTURE_MEMORY)["image"],
        api.gaussian_blur(img, level=2)["image"])
    assert api.get_runtime().device == torch.device("cpu")


def test_module_runtime_targets_cuda_unless_asked(monkeypatch, rng):
    # Nothing asked for: the first call starts the runtime on the card, and
    # a host without CUDA raises, naming both ways to ask for the CPU.
    monkeypatch.setattr(api, "_runtime", None)
    img = make_image(rng, 8, 8, 3)
    if torch.cuda.is_available():
        assert api.get_runtime().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available") as err:
        api.box_blur(img, 2, 2)
    assert "runtime=" in str(err.value) and "set_device('cpu')" in str(err.value)
    assert api.set_device("cpu").device == torch.device("cpu")
    assert api.box_blur(img, 2, 2)["image"].shape == img.shape


@pytest.mark.parametrize("call", [
    lambda mod: mod.box_blur(np.zeros((8, 8, 2), np.uint8)),
    lambda mod: mod.gaussian_blur(np.zeros((8, 8), np.uint8)),
    lambda mod: mod.gaussian_blur(np.zeros((8, 8, 3), np.uint8), level=5),
    lambda mod: mod.sobel_edge_detection(np.zeros((8, 8, 3), np.uint8), level=0),
    lambda mod: mod.gaussian_blur(np.zeros((8, 8, 3), np.uint8), radius=40),
    lambda mod: mod.gaussian_blur(np.zeros((8, 8, 3), np.uint8), sigma=0.0),
    lambda mod: mod.box_blur(np.zeros((8, 8, 3), np.uint8), radius=0),
])
def test_same_runtime_errors_as_jax(call):
    with pytest.raises(RuntimeError) as got:
        call(api)
    with pytest.raises(RuntimeError) as want:
        call(jax_api)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CALLS))
def test_level4_matches_jax(rng, shape, name):
    # Level 4: gaussian within 1 of the JAX tiers (folded taps below r = 3,
    # the bf16 band matmul from r = 3: its sum order is XLA's), box exact,
    # Sobel (f32 grey) within the Sobel bound.
    img = make_image(rng, *shape)
    got = CALLS[name](api, img, 4)
    want = CALLS[name](jax_api, img, 4)
    assert set(got) == KEYS
    if name == "gaussian":
        diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
        assert diff.max() <= 1
    else:
        _assert_filter_close(name, got["image"], want["image"])
    level2 = CALLS[name](api, img, 2)["image"]
    if name == "box":
        np.testing.assert_array_equal(got["image"], level2)
    elif name == "gaussian":
        assert np.abs(got["image"].astype(int) - level2.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got["image"], CALLS[name](api, img, 1)["image"])


@pytest.mark.parametrize("name", list(CALLS))
def test_run_all_levels_matches_jax_per_level(rng, name):
    img = make_image(rng, 21, 26, 3)
    rt = FilterRuntime(torch.device("cpu"))
    got = rt.run_all_levels(name, img, sigma=2.0, radius=4)
    assert set(got) == {1, 2}
    for lv, (out, metrics) in got.items():
        want, _ = JAX_RUNTIME.run(name, img, level=lv, sigma=2.0, radius=4)
        _assert_filter_close(name, out, want)
        assert metrics.time_ms > 0 and metrics.fps > 0
        np.testing.assert_array_equal(
            out, rt.run(name, img, level=lv, sigma=2.0, radius=4)[0])


def test_jax_run_all_levels_needs_fusion_on_cpu(rng):
    # The JAX runtime fuses the levels into one program and refuses on the
    # CPU; the port runs the levels one after another on any device.
    img = make_image(rng, 8, 8, 3)
    with pytest.raises(FusionUnavailable):
        JAX_RUNTIME.run_all_levels("box", img, radius=2)
    assert set(FilterRuntime("cpu").run_all_levels("box", img, radius=2)) == {1, 2}


def test_run_all_levels_raises_on_a_bad_level(rng):
    img = make_image(rng, 8, 8, 3)
    rt = FilterRuntime("cpu")
    with pytest.raises(Exception, match="Level must be"):
        rt.run_all_levels("gaussian", img, levels=(1, 5))
    assert set(rt.run_all_levels("gaussian", img, levels=(1, 4))) == {1, 4}
    with pytest.raises(Exception, match="Invalid filter"):
        rt.run_all_levels("median", img)


def test_metrics_use_the_reference_byte_model(rng):
    img = make_image(rng, 16, 20, 3)
    for name, factor in [("gaussian", 4), ("box", 4), ("sobel", 2)]:
        res = CALLS[name](api, img, 2)
        gbps = 16 * 20 * 3 * factor / (res["time_ms"] / 1000.0) / 1024.0**3
        assert res["bandwidth_gbps"] == pytest.approx(gbps)
        assert res["fps"] == pytest.approx(1000.0 / res["time_ms"])


def test_import_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gpu_image_processing_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'gpu_image_processing_tpu']\n"
        "print(len(list(pkgutil.walk_packages(pkg.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- runtime/timing.py -----------------------------------------------------------


def test_spin_outlasts_the_host_enqueue():
    # Twice the host's enqueue time and a pad, in SM cycles at the card's
    # highest clock (so at least that long at any clock), up to the cap.
    assert timing.spin_ms(0.0) == timing.SPIN_PAD_MS
    for enqueue in (0.02, 0.05, 1.0, 10.0):
        ms = timing.spin_ms(enqueue)
        assert ms == pytest.approx(timing.SPIN_FACTOR * enqueue + timing.SPIN_PAD_MS)
        assert ms > enqueue
        assert timing.spin_cycles(ms) == int(ms * 1e-3 * timing.SPIN_CLOCK_HZ)
    assert timing.spin_ms(1e6) == timing.MAX_SPIN_MS
    assert timing.spin_ms(-1.0) == timing.SPIN_PAD_MS
    # A rows launch's host time (tens of us) gives a spin of about 0.1 ms,
    # not tens of ms.
    assert timing.spin_ms(0.05) < 0.2


def test_cpu_timing_is_wall_time():
    import time

    def fn():
        time.sleep(0.005)
        return torch.zeros(1)

    out, ms, host_ms = timing.timed(fn, torch.device("cpu"), reps=2,
                                    enqueue_ms=123.0)
    assert torch.equal(out, torch.zeros(1))
    assert 5.0 <= ms < 1000.0 and host_ms == ms


def test_runtime_keeps_each_keys_enqueue_time(rng):
    rt = FilterRuntime("cpu")
    img = make_image(rng, 12, 14, 3)
    rt.box_blur(img, 2, 2)
    rt.box_blur(img, 2, 2)
    (key,) = rt.executables
    exe = next(iter(rt.executables.values()))
    assert key[:2] == ("box", 2) and exe.enqueue_ms > 0


@pytest.mark.cuda
def test_box_l2_time_ms_reads_the_kernel_time():
    # time_ms brackets the card's work only: within 10% of the kernel's own
    # event time, measured with the card's queue filled.
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    from gpu_image_processing_tpu_torch.ops.cuda import blur

    dev = torch.device("cuda")
    img = np.random.default_rng(3).integers(0, 256, (2146, 3239, 3), np.uint8)
    rt = FilterRuntime(dev)
    rows = torch.from_numpy(img.reshape(2146, -1)).to(dev)
    for _ in range(10):
        blur.box_rows(rows, 5, 3)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(20):
        blur.box_rows(rows, 5, 3)
    end.record()
    end.synchronize()
    kernel_ms = start.elapsed_time(end) / 20
    time_ms = min(rt.box_blur(img, 5, 2)[1].time_ms for _ in range(5))
    assert abs(time_ms - kernel_ms) <= 0.1 * kernel_ms, (time_ms, kernel_ms)
