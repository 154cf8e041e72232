"""Batch data-parallel filtering: a stack of images split across the devices
of a mesh.  The port of the JAX package's `parallel/batch.py`.

Each device filters a contiguous block of the batch on its own; no shard
needs another's rows, so nothing moves between devices until the gather.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import ref
from ..ops.cuda import api as cuda_api
from .mesh import Mesh
from .spatial import edge_pad


def _per_block(filter_name: str, radius: int, level: int) -> Callable:
    """fn(block, weights) of a (b, H, W, C) block on its device.  Level 1
    runs `ops/ref.py`; other levels the planar tier's level-2 functions, one
    launch of the rows kernel a block on its (b, H, W*C) view, as the JAX
    package's XLA-fused level 2 computes them.  Sobel keeps its level's
    grey rule, as the JAX batch filter's `ref.sobel(im, level)` does: level
    2 quantizes it, levels 1 and 4 keep it in f32."""
    if filter_name == "gaussian":
        if level == 1:
            return lambda blk, w: ref.gaussian_blur(blk, w.to(blk.device), radius)
        impl = cuda_api.level2_impls()["gaussian"]
        return lambda blk, w: impl(blk, w, radius)
    if filter_name == "box":
        impl = ref.box_blur if level == 1 else cuda_api.level2_impls()["box"]
        return lambda blk, w: impl(blk, radius)
    if filter_name == "sobel":
        if level == 1:
            return lambda blk, w: ref.sobel(blk, 1)
        return lambda blk, w: cuda_api.edges(blk, 2 if level == 2 else 4)
    raise ValueError(f"Unknown filter: {filter_name}")


def make_batch_filter(mesh: Mesh, filter_name: str, radius: int = 3,
                      level: int = 2) -> Callable:
    """A batch filter with the batch split over every device of the mesh.

    fn(imgs, [weights]) takes a (B, H, W, C) uint8 array or tensor, any B:
    a batch that does not divide the device count is padded with copies of
    the last image and cropped after (each image is filtered on its own, so
    pad images cannot change real outputs).  Gaussian also takes its
    (2r+1,) float32 table.  Returns the (B, H, W, C) uint8 tensor on the
    mesh's first device.
    """
    per_block = _per_block(filter_name, radius, level)
    devices = mesh.devices.ravel().tolist()
    n = len(devices)

    def fn(imgs, weights=None) -> torch.Tensor:
        x = (imgs if torch.is_tensor(imgs)
             else torch.from_numpy(np.require(imgs, requirements=["C", "W"])))
        b = x.shape[0]
        x = edge_pad(x, -b % n, 0)
        w = cuda_api.table(weights) if weights is not None else None
        per = x.shape[0] // n
        outs = [per_block(x[i * per:(i + 1) * per].to(dev).contiguous(), w)
                for i, dev in enumerate(devices)]
        return torch.cat([o.to(devices[0]) for o in outs])[:b]

    return fn
