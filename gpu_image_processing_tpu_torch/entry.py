"""The flagship forward step on the planar model surface.

`entry(device)` is the counterpart of the JAX package's
`__graft_entry__.entry`: the level-2 fused gaussian blur (sigma 2.0,
radius 3) on a 256 x 384 RGB image made from seed 0, returned as
`(forward, (image, weights))` with both tensors on `device` (the card
unless the caller names another).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .models.filters import GaussianBlur
from .ops.weights import gaussian_kernel_f32, weights_to_torch
from .runtime.device import resolve

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
