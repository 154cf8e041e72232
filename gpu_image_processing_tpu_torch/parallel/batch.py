"""Batch data-parallel filtering: a stack of images split across the devices
of a mesh.  The port of the JAX package's `parallel/batch.py`.

Each device filters a contiguous block of the batch on its own; no shard
needs another's rows, so nothing moves between devices until the gather.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.params import FILTERS
from ..ops.cuda import api as cuda_api
from .mesh import Mesh
from .spatial import edge_pad


def make_batch_filter(mesh: Mesh, filter_name: str, radius: int = 3,
                      level: int = 2) -> Callable:
    """A batch filter with the batch split over every device of the mesh.

    fn(imgs, [weights]) takes a (B, H, W, C) uint8 array or tensor, any B:
    a batch that does not divide the device count is padded with copies of
    the last image and cropped after (each image is filtered on its own, so
    pad images cannot change real outputs).  Gaussian also takes its
    (2r+1,) float32 table.  Returns the (B, H, W, C) uint8 tensor on the
    mesh's first device.

    Each block is one call of the planar tier (`ops/cuda/api.py`, whose
    route picks the function) on its device, at the level the JAX batch
    filter computes: level 1, or its XLA-fused level 2 for gaussian and box
    at levels 2 and 4; Sobel keeps its level's grey rule, as the JAX batch
    filter's `ref.sobel(im, level)` does.
    """
    if filter_name not in FILTERS:
        raise ValueError(f"Unknown filter: {filter_name}")
    served = level if filter_name == "sobel" else min(level, 2)
    devices = mesh.devices.ravel().tolist()
    n = len(devices)

    def fn(imgs, weights=None) -> torch.Tensor:
        x = (imgs if torch.is_tensor(imgs)
             else torch.from_numpy(np.require(imgs, requirements=["C", "W"])))
        b = x.shape[0]
        x = edge_pad(x, -b % n, 0)
        w = cuda_api.table(weights) if weights is not None else None
        per = x.shape[0] // n
        outs = [cuda_api.filtered(x[i * per:(i + 1) * per].to(dev), filter_name,
                                  served, radius, w)
                for i, dev in enumerate(devices)]
        return torch.cat([o.to(devices[0]) for o in outs])[:b]

    return fn
