"""Filter models: configured, composable filter modules.

The counterparts of the JAX package's `models/filters.py`.  Each family is
an `nn.Module` with two faces:

* `forward(image, ...)` (the JAX `apply`): a function of an (H, W, C)
  uint8 tensor on its own device, composable in the caller's code and in
  `nn.Sequential`.  Level 1 is the plain reference (`ops/ref.py`); levels
  2 and 4 are the level-2 function of the registry (`ops/fused.py`), as in
  the JAX package, whose `apply` never takes an "_adv" key: the level-4
  functions are reached through the registry only.
* `run(np_image)` (the JAX `__call__`): one call through the filter
  runtime, `(image, metrics dict)`, on `runtime=` or the API's module
  runtime, which targets the card unless the caller asked for the CPU.

Parameters are validated in `__init__` with the JAX package's errors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..api.filters import get_runtime
from ..core import config
from ..core.params import (
    normalize_level,
    validate_box_params,
    validate_gaussian_params,
)
from ..ops import fused, ref
from ..ops.cuda.api import table
from ..ops.weights import gaussian_kernel_f32, weights_to_torch
from ..runtime.dispatch import FilterRuntime


def _level2(name: str):
    """The level-2 implementation of `name` in the registry."""
    impls: dict = {}
    fused.register_all(impls.__setitem__)
    return impls[name]


def _refresh_host_weights(module: "GaussianBlur", _incompatible) -> None:
    module.host_weights = module.weights.detach().cpu().clone()


class GaussianBlur(nn.Module):
    """Separable gaussian blur; its (2r+1,) float32 table is the buffer
    `weights`, which `.to(device)` moves with the module.

    `host_weights` is a copy of the table that stays on the host (a plain
    attribute, so `.to()` and `state_dict()` leave it out): the level-2
    kernels take their taps by value, and a table on the card would be read
    back, which waits for the card.  Loading a state dict refreshes it.
    """

    weights: torch.Tensor

    def __init__(self, sigma: float = config.DEFAULT_SIGMA,
                 radius: int = config.DEFAULT_RADIUS, level: int = 2):
        super().__init__()
        validate_gaussian_params(sigma, radius)
        normalize_level("gaussian", level)
        self.sigma, self.radius, self.level = sigma, radius, level
        self.register_buffer("weights", weights_to_torch(
            gaussian_kernel_f32(radius, float(sigma)), torch.device("cpu")))
        self.host_weights = self.weights.clone()
        self.register_load_state_dict_post_hook(_refresh_host_weights)

    def forward(self, image: torch.Tensor,
                weights: torch.Tensor | np.ndarray | None = None) -> torch.Tensor:
        """(H, W, C) u8 -> u8.  `weights` replaces the module's table: a
        tensor (level 1 moves it to the image's device; levels 2 and 4 take
        it on the host or the image's device), or a numpy table such as the
        JAX model's `weights`, taken bit for bit."""
        if normalize_level("gaussian", self.level) == 1:
            w = self.weights if weights is None else table(weights).to(image.device)
            return ref.gaussian_blur(image, w, self.radius)
        w = self.host_weights if weights is None else table(weights)
        return _level2("gaussian")(image, w, self.radius)

    def run(self, image: np.ndarray, runtime: FilterRuntime | None = None
            ) -> tuple[np.ndarray, dict]:
        out, metrics = (runtime or get_runtime()).gaussian_blur(
            image, sigma=self.sigma, radius=self.radius, level=self.level)
        return out, metrics.as_dict()

    def extra_repr(self) -> str:
        return f"sigma={self.sigma}, radius={self.radius}, level={self.level}"


class BoxBlur(nn.Module):
    """Separable box blur."""

    def __init__(self, radius: int = config.DEFAULT_RADIUS, level: int = 2):
        super().__init__()
        validate_box_params(radius)
        normalize_level("box", level)
        self.radius, self.level = radius, level

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        lvl = normalize_level("box", self.level)
        impl = ref.box_blur if lvl == 1 else _level2("box")
        return impl(image, self.radius)

    def run(self, image: np.ndarray, runtime: FilterRuntime | None = None
            ) -> tuple[np.ndarray, dict]:
        out, metrics = (runtime or get_runtime()).box_blur(
            image, radius=self.radius, level=self.level)
        return out, metrics.as_dict()

    def extra_repr(self) -> str:
        return f"radius={self.radius}, level={self.level}"


class SobelEdgeDetection(nn.Module):
    """Sobel edge magnitude, written to every channel."""

    def __init__(self, level: int = 2):
        super().__init__()
        normalize_level("sobel", level)
        self.level = level

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        if normalize_level("sobel", self.level) == 1:
            return ref.sobel(image, 1)
        return _level2("sobel")(image)

    def run(self, image: np.ndarray, runtime: FilterRuntime | None = None
            ) -> tuple[np.ndarray, dict]:
        out, metrics = (runtime or get_runtime()).sobel_edge_detection(
            image, level=self.level)
        return out, metrics.as_dict()

    def extra_repr(self) -> str:
        return f"level={self.level}"


def get_filter(name: str, **params) -> nn.Module:
    """Factory by API name: get_filter('gaussian', sigma=3.0, level=2)."""
    families = {
        "gaussian": GaussianBlur,
        "box": BoxBlur,
        "sobel": SobelEdgeDetection,
    }
    if name not in families:
        raise ValueError(f"Unknown filter: {name}")
    return families[name](**params)
