"""Drop-in replacement for the reference's `gpu_filters` pybind module.

Function signatures, defaults, return dicts, and exported level constants
match backend/cuda_bindings/bindings.cpp:240-283:

    gaussian_blur(image, sigma=2.0, radius=3, level=1)
    box_blur(image, radius=3, level=1)
    sobel_edge_detection(image, level=1)
    NAIVE=1, SHARED_MEMORY=2, TEXTURE_MEMORY=3

Each returns ``{"image": np.uint8 HWC, "time_ms": float,
"bandwidth_gbps": float, "fps": float}`` (bindings.cpp:84-90).  Errors are
raised as RuntimeError to match pybind's std::runtime_error translation.

The functions run on the caller's `runtime=` when one is passed, else on
the module runtime.  That runtime is created at first use on the CUDA card,
unless the caller asked for another device with `set_device` (for example
`set_device("cpu")`).  On a host without CUDA, a call that asked for
nothing raises: the CPU serves only when it was asked for.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from ..core import config
from ..core.params import NAIVE, SHARED_MEMORY, TEXTURE_MEMORY, ValidationError
from ..runtime.dispatch import FilterRuntime

__all__ = [
    "gaussian_blur",
    "box_blur",
    "sobel_edge_detection",
    "set_device",
    "get_runtime",
    "NAIVE",
    "SHARED_MEMORY",
    "TEXTURE_MEMORY",
]

_LOCK = threading.Lock()
_runtime: FilterRuntime | None = None


def set_device(device: torch.device | str) -> FilterRuntime:
    """Bind the module runtime to `device` (``"cpu"`` asks for the CPU)."""
    global _runtime
    runtime = FilterRuntime(device)
    with _LOCK:
        _runtime = runtime
    return runtime


def get_runtime() -> FilterRuntime:
    """The module runtime: the one `set_device` bound, else one on the CUDA
    card, created now.  Raises on a host without CUDA."""
    global _runtime
    with _LOCK:
        if _runtime is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available and no device was asked for; to "
                    "run on the CPU pass runtime=FilterRuntime('cpu') or call "
                    "set_device('cpu') first")
            _runtime = FilterRuntime("cuda")
        return _runtime


def _call(method_name: str, runtime: FilterRuntime | None, *args,
          **kwargs) -> dict:
    method: Callable = getattr(runtime or get_runtime(), method_name)
    try:
        out, metrics = method(*args, **kwargs)
    except ValidationError as exc:
        raise RuntimeError(str(exc)) from None
    return {
        "image": out,
        "time_ms": float(metrics.time_ms),
        "bandwidth_gbps": float(metrics.bandwidth_gbps),
        "fps": float(metrics.fps),
    }


def gaussian_blur(
    image: np.ndarray,
    sigma: float = config.DEFAULT_SIGMA,
    radius: int = config.DEFAULT_RADIUS,
    level: int = config.DEFAULT_LEVEL,
    *,
    runtime: FilterRuntime | None = None,
) -> dict:
    """Apply Gaussian blur.

    level: 1=naive, 2=optimized, 4=advanced (accepts the TEXTURE_MEMORY=3
    and SHARED_MEMORY=2 aliases the reference's own tools use, see
    core/params.py).
    """
    return _call("gaussian_blur", runtime, image, sigma=float(sigma),
                 radius=int(radius), level=int(level))


def box_blur(
    image: np.ndarray,
    radius: int = config.DEFAULT_RADIUS,
    level: int = config.DEFAULT_LEVEL,
    *,
    runtime: FilterRuntime | None = None,
) -> dict:
    """Apply box blur. level: 1=naive, 2=optimized, 4=advanced."""
    return _call("box_blur", runtime, image, radius=int(radius),
                 level=int(level))


def sobel_edge_detection(
    image: np.ndarray,
    level: int = config.DEFAULT_LEVEL,
    *,
    runtime: FilterRuntime | None = None,
) -> dict:
    """Apply Sobel edge detection. level: 1=naive, 2=optimized, 4=advanced."""
    return _call("sobel_edge_detection", runtime, image, level=int(level))
