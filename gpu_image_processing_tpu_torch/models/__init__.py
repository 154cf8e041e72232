"""Filter models: `nn.Module`s over (H, W, C) uint8 tensors."""

from .filters import BoxBlur, GaussianBlur, SobelEdgeDetection, get_filter  # noqa: F401
