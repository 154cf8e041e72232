"""The port's multi-device serving (runtime/dispatch.py): row-sharded
single-image serving (GIP_TPU_MESH_SPATIAL=1) and mesh-batch serving
(GIP_TPU_MESH_BATCH=1) through `FilterRuntime("cpu", mesh_devices=[cpu] *
8)`, against single-device serving and the JAX package's RUNTIME under the
same switches on conftest.py's 8 virtual CPU devices, and the profiler's
provenance of such requests.

Tolerance: bit-exact everywhere, with one exception: colour level-2 Sobel
against the JAX package, where XLA's FMA contraction of the grey value
moves .5 ties (the port equals the numpy oracle there, and JAX within the
tolerance's bound of 6).  Level-4 gaussian under row-sharded serving is the level-2
function, as in the JAX package (dispatch.py:1384-1388 there).
"""

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.runtime.dispatch import RUNTIME as JAX_RUNTIME
from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES
from gpu_image_processing_tpu_torch.parallel.spatial import ShardedFilter
from gpu_image_processing_tpu_torch.profiling.profiler import (
    PROFILE_REPS,
    profile_batch,
    profile_filter,
)
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

from . import oracle_numpy as oracle

CPU8 = ["cpu"] * 8


@pytest.fixture
def spatial_env(monkeypatch):
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL", "1")
    # 8 rows a shard exercise the halo exchange on small images.
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "8")
    monkeypatch.delenv("GIP_TPU_MESH_BATCH", raising=False)


@pytest.fixture
def rt8():
    return FilterRuntime("cpu", mesh_devices=CPU8)


def _spatial_keys(rt):
    return [k for k in rt._warm if k[0] == "spatial"]


def _served(rt, monkeypatch, spatial, filt, img, **kw):
    if spatial:
        monkeypatch.setenv("GIP_TPU_MESH_SPATIAL", "1")
    else:
        monkeypatch.delenv("GIP_TPU_MESH_SPATIAL", raising=False)
    return rt.run(filt, img, **kw)[0]


def _jax_spatial(monkeypatch, filt, img, **kw):
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL", "1")
    return np.asarray(JAX_RUNTIME.run(filt, img, **kw)[0])


def test_mesh_devices_default_and_explicit():
    assert FilterRuntime("cpu").mesh_devices == (torch.device("cpu"),)
    rt = FilterRuntime("cpu", mesh_devices=CPU8)
    assert rt.mesh_devices == (torch.device("cpu"),) * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FilterRuntime("cpu", mesh_devices=["cuda:0"] * 2)


@pytest.mark.parametrize("level", [1, 2, 4])
def test_gaussian_spatial_bit_equal(spatial_env, monkeypatch, rt8, level):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (100, 97, 3), np.uint8)   # H uneven vs sp = 8
    kw = dict(sigma=2.0, radius=3)
    want = _served(rt8, monkeypatch, False, "gaussian", img, level=2, **kw)
    got = _served(rt8, monkeypatch, True, "gaussian", img, level=level, **kw)
    assert ("spatial", "gaussian", 2, 100, 97, 3, 3, 8) in _spatial_keys(rt8)
    # Every level is served by the level-2 function, level 4 included (not
    # the band, which single-device level 4 runs at r = 3).
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jax_spatial(monkeypatch, "gaussian", img, level=level, **kw))
    if level == 4:
        single_l4 = _served(rt8, monkeypatch, False, "gaussian", img, level=4, **kw)
        assert np.abs(single_l4.astype(int) - want).max() <= 1


def test_box_spatial_bit_equal(spatial_env, monkeypatch, rt8):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (96, 64, 4), np.uint8)   # H divisible, RGBA
    want = _served(rt8, monkeypatch, False, "box", img, radius=5, level=2)
    got = _served(rt8, monkeypatch, True, "box", img, radius=5, level=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jax_spatial(monkeypatch, "box", img, radius=5, level=2))
    assert _spatial_keys(rt8) == [("spatial", "box", 2, 96, 64, 4, 5, 8)]


@pytest.mark.parametrize("level", [1, 2, 4])
def test_sobel_spatial_bit_equal(spatial_env, monkeypatch, rt8, level):
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (101, 80, 3), np.uint8)   # padded bottom row
    want = _served(rt8, monkeypatch, False, "sobel", img, level=level)
    got = _served(rt8, monkeypatch, True, "sobel", img, level=level)
    np.testing.assert_array_equal(got, want)
    assert not got[-1].any() and not got[0].any()
    assert not got[:, 0].any() and not got[:, -1].any()
    jax_got = _jax_spatial(monkeypatch, "sobel", img, level=level)
    if level == 2:
        # The quantized grey: XLA contracts the Rec.601 sum into FMAs, so a
        # grey value on a .5 tie may round the other way on the JAX side; on
        # this image JAX differs from the numpy oracle on 0.136% of pixels
        # (by at most 2), past tests/sobel_tolerance.py's 0.1%.  The port
        # rounds each product as the oracle does and equals it bit for bit;
        # against JAX it stays within the tolerance's bound of 6.
        np.testing.assert_array_equal(got, oracle.sobel(img, 2))
        assert np.abs(got.astype(int) - jax_got).max() <= 6
    else:
        np.testing.assert_array_equal(got, jax_got)
    # Level 4 serves the level-1 grey rule.
    served = {1: 1, 2: 2, 4: 1}[level]
    assert _spatial_keys(rt8) == [("spatial", "sobel", served, 101, 80, 3, None, 8)]


def test_grayscale_spatial(spatial_env, monkeypatch, rt8):
    rng = np.random.default_rng(15)
    img = rng.integers(0, 256, (88, 50, 1), np.uint8)
    for filt, kw in (("gaussian", dict(sigma=1.0, radius=2, level=2)),
                     ("sobel", dict(level=2))):
        want = _served(rt8, monkeypatch, False, filt, img, **kw)
        got = _served(rt8, monkeypatch, True, filt, img, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _jax_spatial(monkeypatch, filt, img, **kw))
    assert len(_spatial_keys(rt8)) == 2


def test_gpu_filters_entry_points_route_spatially(spatial_env, rt8):
    rng = np.random.default_rng(16)
    img = rng.integers(0, 256, (72, 40, 3), np.uint8)
    rt8.gaussian_blur(img, 1.5, 2, 2)
    rt8.box_blur(img, 3, 2)
    rt8.sobel_edge_detection(img, 2)
    assert {k[1] for k in _spatial_keys(rt8)} == {"gaussian", "box", "sobel"}


def test_small_images_stay_on_one_device(spatial_env, monkeypatch, rt8):
    # The default floor, 64 rows a shard, needs 512 rows over 8 devices.
    monkeypatch.delenv("GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD")
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (32, 40, 3), np.uint8)
    rt8.box_blur(img, radius=3, level=2)
    assert _spatial_keys(rt8) == []
    assert list(rt8._warm) == [("box", 2, 1, 32, 40, 3, 3)]


def test_switch_off_and_one_device_keep_single_device_paths(monkeypatch):
    rng = np.random.default_rng(17)
    img = rng.integers(0, 256, (64, 40, 3), np.uint8)
    monkeypatch.delenv("GIP_TPU_MESH_SPATIAL", raising=False)
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "1")
    rt = FilterRuntime("cpu", mesh_devices=CPU8)
    rt.box_blur(img, 2, 2)
    # A one-device runtime takes no path even with the switches on.
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL", "1")
    monkeypatch.setenv("GIP_TPU_MESH_BATCH", "1")
    one = FilterRuntime("cpu")
    one.box_blur(img, 2, 2)
    one.run_batch("box", np.stack([img] * 3), level=2, radius=2)
    assert list(rt._warm) == [("box", 2, 1, 64, 40, 3, 2)]
    assert list(one._warm) == [("box", 2, 1, 64, 40, 3, 2), ("box", 2, 3, 64, 40, 3, 2)]


def test_run_all_levels_stays_on_one_device(spatial_env, rt8):
    rng = np.random.default_rng(18)
    img = rng.integers(0, 256, (80, 33, 3), np.uint8)
    out = rt8.run_all_levels("gaussian", img, sigma=2.0, radius=3,
                             levels=(1, 2, 4))
    assert set(out) == {1, 2, 4}
    assert _spatial_keys(rt8) == []


def test_spatial_time_ms_and_metrics(spatial_env, rt8):
    rng = np.random.default_rng(19)
    img = rng.integers(0, 256, (80, 33, 3), np.uint8)
    out, metrics = rt8.run("box", img, level=2, radius=2)
    assert out.shape == img.shape
    assert metrics.time_ms > 0 and metrics.fps > 0 and metrics.bandwidth_gbps > 0


# -- mesh-batch serving -----------------------------------------------------

MESH_BATCH = [("gaussian", 2, dict(sigma=2.0, radius=3)),
              ("gaussian", 4, dict(sigma=2.0, radius=3)),
              ("gaussian", 1, dict(sigma=1.5, radius=2)),
              ("box", 2, dict(radius=3)),
              ("sobel", 2, {}),
              ("sobel", 4, {})]


@pytest.mark.parametrize("filt, level, kw", MESH_BATCH)
def test_mesh_batch_uneven_matches_single_device_and_jax(monkeypatch, rt8, filt,
                                                         level, kw):
    rng = np.random.default_rng(20)
    imgs = rng.integers(0, 256, (5, 24, 31, 3), np.uint8)   # 5 % 8 != 0
    monkeypatch.delenv("GIP_TPU_MESH_BATCH", raising=False)
    want, _ = rt8.run_batch(filt, imgs, level=level, **kw)
    monkeypatch.setenv("GIP_TPU_MESH_BATCH", "1")
    got, metrics = rt8.run_batch(filt, imgs, level=level, **kw)
    assert got.shape == imgs.shape
    np.testing.assert_array_equal(got, want)
    assert any(k[0] == "mesh_batch" and k[-1] == 8 for k in rt8._warm)
    assert metrics.fps == pytest.approx(5 * 1000.0 / metrics.time_ms)
    jax_out, _ = JAX_RUNTIME.run_batch(filt, imgs, level=level, **kw)
    jax_out = np.asarray(jax_out)
    if level == 4 and filt == "gaussian":
        # The level-4 band sums in its own order on each side.
        assert np.abs(got.astype(int) - jax_out).max() <= 1
    else:
        np.testing.assert_array_equal(got, jax_out)


# -- profiler provenance ----------------------------------------------------


def test_profile_filter_spatial(spatial_env, monkeypatch, rt8):
    # The profiled runs are the row-sharded call's own steps.
    steps = []
    step = ShardedFilter.step
    monkeypatch.setattr(ShardedFilter, "step",
                        lambda self, *a: steps.append(self.mesh.size) or step(self, *a))
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (100, 97, 3), np.uint8)
    deep = profile_filter(rt8, img, "gaussian", 2, sigma=2.0, radius=3)
    assert deep["config"]["Serving Path"] == "spatial(sp=8)"
    assert deep["total_kernel_duration_ms"] > 0
    assert deep["kernels_profiled"] == ["gaussian_blur_fused_l2"]
    assert steps == [8] * (PROFILE_REPS + 1)


def test_profile_filter_single_device_provenance(spatial_env, monkeypatch, rt8):
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "4096")
    rng = np.random.default_rng(22)
    img = rng.integers(0, 256, (24, 30, 3), np.uint8)
    deep = profile_filter(rt8, img, "sobel", 2)
    assert deep["config"]["Serving Path"] == "single_image"


def test_profile_batch_mesh_provenance(monkeypatch, rt8):
    rng = np.random.default_rng(23)
    imgs = rng.integers(0, 256, (3, 16, 20, 3), np.uint8)
    monkeypatch.setenv("GIP_TPU_MESH_BATCH", "1")
    deep = profile_batch(rt8, imgs, "box", 2, radius=2)
    assert deep["config"]["Serving Path"] == "batch(dp=8)"
    assert deep["config"]["Batch Size"] == 3
    assert deep["total_kernel_duration_ms"] > 0
    monkeypatch.delenv("GIP_TPU_MESH_BATCH")
    assert profile_batch(rt8, imgs, "box", 2, radius=2)["config"]["Serving Path"] == "batch"


@pytest.mark.cuda
def test_spatial_and_mesh_batch_serving_on_one_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rt = FilterRuntime("cuda", mesh_devices=["cuda:0"] * 4)
    rng = np.random.default_rng(24)
    img = rng.integers(0, 256, (300, 131, 3), np.uint8)
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "8")
    for filt, kw in (("gaussian", dict(sigma=2.0, radius=3, level=2)),
                     ("box", dict(radius=5, level=2)), ("sobel", dict(level=2))):
        monkeypatch.delenv("GIP_TPU_MESH_SPATIAL", raising=False)
        want, _ = rt.run(filt, img, **kw)
        monkeypatch.setenv("GIP_TPU_MESH_SPATIAL", "1")
        LAUNCHES.clear()
        got, metrics = rt.run(filt, img, **kw)
        np.testing.assert_array_equal(got, want)
        assert sum(LAUNCHES.values()) >= 4 and metrics.time_ms > 0
    monkeypatch.delenv("GIP_TPU_MESH_SPATIAL")
    single, _ = rt.run("gaussian", img, sigma=2.0, radius=3, level=2)
    monkeypatch.setenv("GIP_TPU_MESH_BATCH", "1")
    LAUNCHES.clear()
    got, _ = rt.run_batch("gaussian", np.stack([img] * 5), level=2, sigma=2.0,
                          radius=3)
    # 5 images padded to 8, one launch on each of the 4 blocks.
    assert LAUNCHES["gaussian_rows"] == 4
    for i in range(5):
        np.testing.assert_array_equal(got[i], single)
