"""uint8 quantization matching the CUDA `(unsigned char)(x + 0.5f)` cast.

Every kernel in the reference converts its f32 accumulator back to uint8 with
`(unsigned char)(sum + 0.5f)` (e.g. image_filters.cu:102,394,1232,1444).  A C
cast truncates toward zero; for the non-negative sums produced by these
filters this is `floor(sum + 0.5)` -- round-half-up, NOT round-half-even, so
`torch.round` would be wrong for *.5 values.
"""

from __future__ import annotations

import torch


def quantize_u8_f32(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5) clamped to [0, 255], staying in float32.

    The separable blurs store their horizontal pass as uint8 before the
    vertical pass (image_filters.cu:761,811-839); the float copy of that
    value keeps the second pass bit-identical.
    """
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5) clamped to [0, 255], as uint8."""
    return quantize_u8_f32(x).to(torch.uint8)
