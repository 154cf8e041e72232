"""gpu_image_processing_tpu_torch: the PyTorch/CUDA port of the filter stack.

A second package beside the JAX reference `gpu_image_processing_tpu`, with
the same module names so each counterpart is easy to find:

* Pallas kernels             -> hand-written CUDA C++ for Hopper (ops/cuda/)
* jnp level-1 ops            -> plain torch ops (ops/interleaved.py)
* jit-cache dispatch runtime -> FilterRuntime on an explicit torch.device
                                (runtime/)
* filter model dataclasses   -> nn.Modules over (H, W, C) tensors (models/)

It imports torch and never jax.  Top-level exports mirror the `gpu_filters`
module surface (backend/cuda_bindings/bindings.cpp:240-283).
"""

from .api.filters import (  # noqa: F401
    NAIVE,
    SHARED_MEMORY,
    TEXTURE_MEMORY,
    box_blur,
    gaussian_blur,
    sobel_edge_detection,
)

__version__ = "0.1.0"

__all__ = [
    "gaussian_blur",
    "box_blur",
    "sobel_edge_detection",
    "NAIVE",
    "SHARED_MEMORY",
    "TEXTURE_MEMORY",
    "__version__",
]
