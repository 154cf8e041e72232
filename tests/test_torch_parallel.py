"""The port's multi-device builders (parallel/{mesh,spatial,batch}.py and
entry.dryrun_multichip) against the JAX package's on the 8-virtual-device
CPU mesh of conftest.py.

The port runs on `make_mesh(8, devices=[cpu] * 8)`: one process, eight CPU
shards with real halo exchange.  Both sides get the same numpy inputs from
a seed.  `use_kernels=False` is held against the JAX `use_pallas=False`
plain bodies, `use_kernels=True` (the kernels' wrappers, which serve their
plain versions on CPU tensors) against `use_pallas=True` (Pallas in
interpret mode).  Tolerance: bit-exact everywhere, colour Sobel included
(measured maxdiff 0); colour Sobel against the numpy oracle is held to
`tests/sobel_tolerance.py`, as in tests/test_parallel.py.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu.parallel.batch import make_batch_filter as jax_batch
from gpu_image_processing_tpu.parallel.mesh import make_mesh as jax_mesh
from gpu_image_processing_tpu.parallel.spatial import (
    make_sharded_filter as jax_sharded,
    spatial_h_target as jax_h_target,
)
from gpu_image_processing_tpu_torch.entry import dryrun_multichip
from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES
from gpu_image_processing_tpu_torch.parallel import spatial
from gpu_image_processing_tpu_torch.parallel.batch import make_batch_filter
from gpu_image_processing_tpu_torch.parallel.mesh import Mesh, make_mesh
from gpu_image_processing_tpu_torch.parallel.spatial import (
    exchange_halo_rows,
    make_sharded_filter,
    spatial_h_target,
)

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jax8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_mesh(8)


def _batch(rng, b, h, w, c):
    return np.stack([make_image(rng, h, w, c) for _ in range(b)])


# -- mesh -------------------------------------------------------------------


def test_mesh_shape(mesh8):
    assert isinstance(mesh8, Mesh)
    assert mesh8.devices.shape == (2, 4)
    assert mesh8.axis_names == ("dp", "sp")
    assert mesh8.shape == {"dp": 2, "sp": 4} and mesh8.size == 8
    assert all(d == torch.device("cpu") for d in mesh8.devices.ravel())
    assert mesh8.distinct_devices() == (torch.device("cpu"),)


@pytest.mark.parametrize("n, split", [(2, (1, 2)), (4, (2, 2)), (8, (2, 4))])
def test_mesh_default_split_is_the_jax_one(n, split):
    assert make_mesh(n, devices=CPU8).devices.shape == split
    assert jax_mesh(n).devices.shape == split
    assert make_mesh(n, dp=n, devices=CPU8).devices.shape == (n, 1)
    assert make_mesh(n, sp=n, devices=["cpu"] * n).devices.shape == (1, n)


def test_mesh_raises_for_more_devices_than_named():
    with pytest.raises(ValueError, match="Requested 9 devices but only 8"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="dp\\*sp"):
        make_mesh(8, dp=3, devices=CPU8)


def test_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the fallback question does not arise")
    # The JAX mesh moves to the CPU platform when too few chips are
    # present; the port raises instead.
    with pytest.raises(ValueError, match="only 0 present"):
        make_mesh(2)
    with pytest.raises(ValueError):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2, devices=["cuda:0"] * 2)


# -- halo exchange ----------------------------------------------------------


def test_exchange_halo_rows_copies_neighbours_and_clamps_edges():
    blocks = [torch.arange(i * 12, i * 12 + 12).view(1, 4, 3) for i in range(3)]
    mid = exchange_halo_rows(blocks[1], blocks[0], blocks[2], 2)
    torch.testing.assert_close(mid[0], torch.arange(6, 30).view(8, 3))
    first = exchange_halo_rows(blocks[0], None, blocks[1], 2)
    torch.testing.assert_close(first[0, :2], blocks[0][0, :1].expand(2, 3))
    torch.testing.assert_close(first[0, 6:], blocks[1][0, :2])
    last = exchange_halo_rows(blocks[2], blocks[1], None, 1, axis=-2)
    torch.testing.assert_close(last[0, -1], blocks[2][0, -1])


@pytest.mark.parametrize("h, sp, f, r", [(100, 8, "gaussian", 3), (10, 4, "gaussian", 8),
                                         (33, 4, "sobel", 3), (2146, 4, "box", 5)])
def test_h_target_is_the_jax_formula(h, sp, f, r):
    assert spatial_h_target(h, sp, f, r) == jax_h_target(h, sp, f, r)


# -- sharded filters --------------------------------------------------------

# (filter, level, radius, batch shape, mesh split): tests/test_parallel.py's
# shapes.  Even shapes; r = 8 with exactly r rows a shard; uneven B and H
# on (dp, sp) = (4, 2); B = 6 with H = 102; shards shorter than r; Sobel
# with H % sp != 0 and B % dp != 0, whose border is zeroed again after
# the crop.
SHARDED = [
    ("gaussian", 2, 3, (2, 32, 40, 3), None),
    ("gaussian", 2, 8, (2, 32, 24, 1), None),
    ("box", 2, 5, (2, 32, 17, 4), None),
    ("sobel", 1, 3, (2, 32, 21, 3), None),
    ("sobel", 2, 3, (2, 32, 21, 3), None),
    ("gaussian", 2, 3, (6, 101, 23, 3), (4, 2)),
    ("box", 2, 5, (6, 102, 17, 4), None),
    ("gaussian", 2, 8, (2, 10, 24, 1), None),
    ("sobel", 1, 3, (3, 33, 21, 3), None),
    ("sobel", 2, 3, (3, 33, 21, 3), None),
    ("sobel", 2, 3, (2, 30, 19, 1), None),
]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("filt, level, radius, shape, split", SHARDED)
def test_sharded_filter_matches_jax(rng, mesh8, jax8, filt, level, radius,
                                    shape, split, use_kernels):
    imgs = _batch(rng, *shape)
    w = gaussian_kernel_f32(radius, 2.0 if radius < 8 else 4.0)
    args = (imgs, w) if filt == "gaussian" else (imgs,)
    port_mesh, tpu_mesh = mesh8, jax8
    if split:
        port_mesh = make_mesh(8, dp=split[0], sp=split[1], devices=CPU8)
        tpu_mesh = jax_mesh(8, dp=split[0], sp=split[1])
    got = make_sharded_filter(port_mesh, filt, radius=radius, level=level,
                              use_kernels=use_kernels)(*args)
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    got = got.numpy()
    want = np.asarray(jax_sharded(tpu_mesh, filt, radius=radius, level=level,
                                  use_pallas=use_kernels)(*args))
    np.testing.assert_array_equal(got, want)
    for i in range(shape[0]):
        if filt == "sobel":
            assert_sobel_close(got[i], oracle.sobel(imgs[i], level))
            assert not got[i][0].any() and not got[i][-1].any()
        elif filt == "gaussian":
            np.testing.assert_array_equal(got[i], oracle.gaussian_blur(imgs[i], w, radius))
        else:
            np.testing.assert_array_equal(got[i], oracle.box_blur(imgs[i], radius))


def test_sharded_filter_runs_in_three_steps(rng, mesh8):
    imgs = _batch(rng, 3, 33, 21, 3)
    fn = make_sharded_filter(mesh8, "box", radius=2)
    blocks = fn.shard(torch.from_numpy(imgs))
    # B 3 -> 4 over dp = 2, H 33 -> 36 over sp = 4: 2 x 4 blocks of (2, 9).
    assert [[tuple(b.shape) for b in row] for row in blocks] == [[(2, 9, 21, 3)] * 4] * 2
    out = fn.gather(fn.step(blocks))
    assert tuple(out.shape) == (4, 36, 21, 3)
    np.testing.assert_array_equal(out[:3, :33].numpy(), fn(imgs).numpy())


def test_sharded_filter_rejects_bad_input(mesh8):
    with pytest.raises(ValueError, match="Unknown filter"):
        make_sharded_filter(mesh8, "median")
    with pytest.raises(ValueError, match="uint8"):
        make_sharded_filter(mesh8, "box")(np.zeros((2, 8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="weight table"):
        make_sharded_filter(mesh8, "gaussian")(np.zeros((2, 8, 8, 3), np.uint8))


def test_sharded_kernels_on_cpu_serve_plain_versions(rng, mesh8):
    # On CPU tensors the wrappers serve their plain versions: no launch.
    LAUNCHES.clear()
    imgs = _batch(rng, 2, 16, 12, 3)
    make_sharded_filter(mesh8, "sobel", level=2)(imgs)
    make_sharded_filter(mesh8, "box", radius=2)(imgs)
    assert sum(LAUNCHES.values()) == 0


# -- batch filters ----------------------------------------------------------

BATCHED = [
    ("gaussian", 2, (8, 16, 19, 3)),
    ("gaussian", 2, (6, 16, 19, 3)),     # 6 % 8 != 0
    ("gaussian", 1, (6, 16, 19, 3)),
    ("box", 2, (5, 12, 13, 4)),
    ("box", 1, (9, 12, 13, 3)),
    ("sobel", 2, (8, 12, 13, 1)),
    ("sobel", 1, (3, 12, 13, 3)),
    ("sobel", 4, (3, 12, 13, 3)),
]


@pytest.mark.parametrize("filt, level, shape", BATCHED)
def test_batch_filter_matches_jax(rng, mesh8, jax8, filt, level, shape):
    imgs = _batch(rng, *shape)
    w = gaussian_kernel_f32(3, 2.0)
    args = (imgs, w) if filt == "gaussian" else (imgs,)
    got = make_batch_filter(mesh8, filt, radius=3, level=level)(*args)
    assert tuple(got.shape) == shape
    want = np.asarray(jax_batch(jax8, filt, radius=3, level=level)(*args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_filter_rejects_unknown_filter(mesh8):
    with pytest.raises(ValueError, match="Unknown filter"):
        make_batch_filter(mesh8, "median")


# -- the dry run ------------------------------------------------------------


def test_dryrun_multichip_on_cpu_devices(capsys):
    dryrun_multichip(8, devices=["cpu"] * 8)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh (dp=2, sp=4)" in out
    assert "spatial serving: 3 filters row-sharded over sp=8" in out


def test_dryrun_multichip_leaves_no_switch_set(monkeypatch):
    monkeypatch.setenv("GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "77")
    monkeypatch.delenv("GIP_TPU_MESH_SPATIAL", raising=False)
    dryrun_multichip(4, devices=["cpu"] * 4)
    import os

    assert os.environ["GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD"] == "77"
    assert "GIP_TPU_MESH_SPATIAL" not in os.environ


@pytest.mark.cuda
def test_sharded_filters_on_one_card_equal_one_device(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    mesh = make_mesh(4, devices=[dev] * 4)
    imgs = _batch(rng, 3, 101, 67, 3)
    w = gaussian_kernel_f32(3, 2.0)
    LAUNCHES.clear()
    got = make_sharded_filter(mesh, "gaussian", radius=3)(imgs, w)
    assert LAUNCHES["gaussian_planar"] == mesh.size
    plain = make_sharded_filter(mesh, "gaussian", radius=3, use_kernels=False)(imgs, w)
    assert torch.equal(got, plain)
    for i in range(3):
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      oracle.gaussian_blur(imgs[i], w, 3))
    assert spatial.spatial_halo("sobel", 3) == 1
