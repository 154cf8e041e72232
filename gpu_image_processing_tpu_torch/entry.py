"""The flagship forward step on the planar model surface, and the
multi-device dry run.

`entry(device)` is the counterpart of the JAX package's
`__graft_entry__.entry`: the level-2 fused gaussian blur (sigma 2.0,
radius 3) on a 256 x 384 RGB image made from seed 0, returned as
`(forward, (image, weights))` with both tensors on `device` (the card
unless the caller names another).  `dryrun_multichip(n_devices)` is the
counterpart of `__graft_entry__.dryrun_multichip`.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from .models.filters import GaussianBlur
from .ops import ref
from .ops.weights import gaussian_kernel_f32, weights_to_torch
from .parallel.mesh import make_mesh
from .parallel.spatial import make_sharded_filter
from .runtime.device import resolve
from .runtime.dispatch import FilterRuntime

SIGMA, RADIUS, LEVEL = 2.0, 3, 2
SHAPE = (256, 384, 3)
SEED = 0


def entry(device: torch.device | str = "cuda"
          ) -> tuple[Callable[..., torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """(forward, (image, weights)) for one forward step of the flagship
    model; raises for a CUDA device on a host without CUDA."""
    device = resolve(device)
    model = GaussianBlur(sigma=SIGMA, radius=RADIUS, level=LEVEL).to(device)
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, size=SHAPE, dtype=np.uint8)
    image = torch.from_numpy(img).to(device)
    weights = weights_to_torch(gaussian_kernel_f32(RADIUS, SIGMA), device)

    def forward(image: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return model(image, w)

    return forward, (image, weights)


def dryrun_multichip(n_devices: int, devices: list | None = None) -> None:
    """Run the (dp, sp)-sharded filters over an `n_devices` mesh on small
    shapes, each against the single-device function for every batch
    element, then row-sharded serving through a `FilterRuntime` against
    single-device serving; raises on any difference.

    `devices=None` takes the visible CUDA cards; a list names the devices,
    one device several times if wished (`["cpu"] * 8` on the CPU,
    `["cuda:0"] * 4` on one card).  The serving switches are set for the
    call and restored after it.
    """
    mesh = make_mesh(n_devices, devices=devices)
    dp, sp = mesh.devices.shape
    dev0 = mesh.devices[0, 0]
    print(f"mesh axes: dp={dp} (batch), sp={sp} (image rows, halo rows "
          f"copied); devices: {', '.join(map(str, mesh.devices.ravel()))}")
    rng = np.random.default_rng(42)
    radius = 2
    weights = gaussian_kernel_f32(radius, 1.5)
    w_dev = weights_to_torch(weights, dev0)

    # A: narrow (W*C = 72), mesh-divisible batch and height;
    # B: wide (W*C = 288) with a dp-uneven batch and an sp-uneven height,
    #    through the pad-and-crop path on both axes.
    even_h = max(4 * sp, 8 * radius)
    cases = [
        ("even/narrow", 2 * dp, even_h + (-even_h) % sp, 24),
        ("uneven/wide", 2 * dp + 1, 4 * sp + 3, 96),
    ]
    single = {
        "gaussian": lambda imgs: ref.gaussian_blur(imgs, w_dev, radius),
        "box": lambda imgs: ref.box_blur(imgs, 3),
        "sobel": lambda imgs: ref.sobel(imgs, 2),
    }
    steps = {
        "gaussian": make_sharded_filter(mesh, "gaussian", radius=radius),
        "box": make_sharded_filter(mesh, "box", radius=3),
        "sobel": make_sharded_filter(mesh, "sobel", level=2),
    }
    for case_name, batch, height, width in cases:
        imgs = rng.integers(0, 256, size=(batch, height, width, 3),
                            dtype=np.uint8)
        imgs_dev = torch.from_numpy(imgs).to(dev0)
        for name, step in steps.items():
            out = step(imgs, weights) if name == "gaussian" else step(imgs)
            # Every batch element: a dp-axis gather or permutation fault
            # must fail here, not pass on element 0 alone.
            want = single[name](imgs_dev)
            if not torch.equal(out, want):
                raise AssertionError(
                    f"{name} mismatch on {case_name} batch {imgs.shape}: "
                    f"maxdiff {(out.int() - want.int()).abs().max().item()}")
        print(f"  case {case_name}: batch {imgs.shape} -> gaussian+box+sobel "
              f"sharded == single-device (all elements)")

    # Row-sharded serving through the runtime (its cache key, host pad and
    # crop, border restore), bit-equal to single-device serving.
    runtime = FilterRuntime(dev0, mesh_devices=mesh.devices.ravel().tolist())
    img = rng.integers(0, 256, size=(n_devices * 12 + 5, 131, 3), dtype=np.uint8)
    switches = ("GIP_TPU_MESH_SPATIAL", "GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD")
    saved = {k: os.environ.get(k) for k in switches}
    try:
        os.environ["GIP_TPU_MESH_SPATIAL_MIN_ROWS_PER_SHARD"] = "8"
        for fname, kw in (("gaussian", dict(sigma=1.5, radius=2, level=2)),
                          ("box", dict(radius=3, level=2)),
                          ("sobel", dict(level=2))):
            os.environ.pop("GIP_TPU_MESH_SPATIAL", None)
            want, _ = runtime.run(fname, img, **kw)
            os.environ["GIP_TPU_MESH_SPATIAL"] = "1"
            got, _ = runtime.run(fname, img, **kw)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"spatial serving {fname} != single-device serving")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    spatial_used = sum(k[0] == "spatial" for k in runtime._warm)
    if spatial_used < 3:
        raise AssertionError("spatial serving path was never routed")
    print(f"  spatial serving: 3 filters row-sharded over sp={n_devices}, "
          f"bit-equal to single-device ({spatial_used} sharded calls)")
    print(f"dryrun_multichip OK: mesh (dp={dp}, sp={sp}), {len(cases)} shape "
          f"cases x 3 filters + spatial serving, full-batch equality")
