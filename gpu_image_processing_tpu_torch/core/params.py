"""Filter specs, optimization levels, and request validation.

Mirrors the reference's level system (cuda_lib/include/image_filters.h:24-29
`enum OptimizationLevel {NAIVE=1, SHARED_MEMORY=2, TEXTURE_MEMORY=3,
ADVANCED=4}`) and the per-filter user-level -> enum remapping done by the
pybind bindings (backend/cuda_bindings/bindings.cpp:46-53,124-132,197-205):
gaussian level 2 -> TEXTURE_MEMORY, box/sobel level 2 -> SHARED_MEMORY.

In this package the distinction is between plain torch ops (level 1) and the
hand-written CUDA kernels (levels 2 and 4); the enum and the level-name
strings are kept for API parity.  Unlike the reference, `gaussianBlur` here accepts the
SHARED_MEMORY alias for level 2 instead of erroring -- the reference's own
C++ tests pass SHARED_MEMORY to gaussianBlur and crash against the current
library (tests/test_comparison.cu:153 vs image_filters.cu:693-696).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from . import config


class OptimizationLevel(enum.IntEnum):
    NAIVE = 1
    SHARED_MEMORY = 2
    TEXTURE_MEMORY = 3
    ADVANCED = 4


#: API-facing integer constants, matching the pybind module attributes
#: (bindings.cpp:280-282).
NAIVE = int(OptimizationLevel.NAIVE)
SHARED_MEMORY = int(OptimizationLevel.SHARED_MEMORY)
TEXTURE_MEMORY = int(OptimizationLevel.TEXTURE_MEMORY)


class ValidationError(ValueError):
    """Raised for bad filter parameters (maps to RuntimeError in bindings)."""


@dataclass(frozen=True)
class FilterSpec:
    """Static description of one filter family."""

    name: str            # API identifier: "gaussian" | "box" | "sobel"
    display_name: str
    description: str
    has_sigma: bool
    has_radius: bool
    # Level-name strings surfaced by the REST API (backend/app.py:256-261).
    level_names: dict[int, str]
    # Human-readable optimization level catalog (backend/app.py:151-177).
    level_catalog: dict[str, str]
    # Byte model used for bandwidth_gbps: bytes = W*H*C*<factor>
    # (image_filters.cu:905 blurs=4, :1711 sobel=2).
    bytes_factor: int


GAUSSIAN = FilterSpec(
    name="gaussian",
    display_name="Gaussian Blur",
    description="Smooth blur with weighted averaging (bell curve)",
    has_sigma=True,
    has_radius=True,
    level_names={1: "naive", 2: "texture_memory", 4: "advanced"},
    level_catalog={
        "1": "Naive (plain torch ops)",
        "2": "Hand-written CUDA kernel (separable passes)",
        "4": "Advanced (folded taps below r=3, bf16 hi+lo band from r=3; "
             "maxdiff<=1 vs level 2)",
    },
    bytes_factor=4,
)

BOX = FilterSpec(
    name="box",
    display_name="Box Blur",
    description="Simple average blur (faster than Gaussian)",
    has_sigma=False,
    has_radius=True,
    level_names={1: "naive", 2: "shared_memory", 4: "advanced"},
    level_catalog={
        "1": "Naive (plain torch ops)",
        "2": "Hand-written CUDA kernel (int32 window sums)",
        "4": "Advanced (the exact level-2 kernel)",
    },
    bytes_factor=4,
)

SOBEL = FilterSpec(
    name="sobel",
    display_name="Sobel Edge Detection",
    description="Detect edges using gradient magnitude (Gx, Gy)",
    has_sigma=False,
    has_radius=False,
    level_names={1: "naive", 2: "shared_memory", 4: "advanced"},
    level_catalog={
        "1": "Naive (plain torch ops)",
        "2": "Hand-written CUDA kernel (quantized gray per pixel)",
        "4": "Advanced (f32 gray, no quantization)",
    },
    bytes_factor=2,
)

FILTERS: dict[str, FilterSpec] = {f.name: f for f in (GAUSSIAN, BOX, SOBEL)}


def normalize_level(filter_name: str, level: int) -> int:
    """Map a user/API level or OptimizationLevel alias to canonical 1, 2 or 4.

    Accepts the enum aliases the reference's own tooling uses: for gaussian
    both TEXTURE_MEMORY(3) and SHARED_MEMORY(2) mean level 2; for box/sobel
    SHARED_MEMORY(2) means level 2.  Level 4 is the ADVANCED tier the
    reference declares but never implements (image_filters.h:28,
    README.md:316): relaxed accumulation order for extra speed, gated at
    max pixel diff <= 1 vs level 2 (the reference's own fidelity threshold,
    tests/test_comparison.cu:204-221).
    """
    if level in (1,):
        return 1
    if level == 2:
        return 2
    if level == 3 and filter_name == "gaussian":
        # TEXTURE_MEMORY alias (bindings map user level 2 -> enum 3).
        return 2
    if level == 4:
        return 4
    raise ValidationError(
        f"Level must be 1 (naive), 2 (optimized), or 4 (advanced) for "
        f"{filter_name}; got {level}"
    )


def validate_image_shape(shape: tuple[int, ...]) -> tuple[int, int, int]:
    """Validate an (H, W, C) uint8 image shape (bindings.cpp:21-31)."""
    if len(shape) != 3:
        raise ValidationError("Input must be 3D array (height, width, channels)")
    height, width, channels = shape
    if channels not in config.VALID_CHANNELS:
        raise ValidationError("Channels must be 1, 3, or 4")
    if height < 1 or width < 1:
        raise ValidationError("Image must be at least 1x1")
    return int(height), int(width), int(channels)


def validate_gaussian_params(sigma: float, radius: int) -> None:
    if not (sigma > 0.0):
        raise ValidationError(f"Sigma must be positive; got {sigma}")
    if radius < 1:
        raise ValidationError(f"Radius must be >= 1; got {radius}")
    if 2 * radius + 1 > config.MAX_KERNEL_TAPS:
        # Same cap as the 64-float constant-memory table
        # (image_filters.cu:729-732).
        raise ValidationError(
            f"Kernel size {2 * radius + 1} exceeds weight-table limit "
            f"({config.MAX_KERNEL_TAPS})"
        )


def validate_box_params(radius: int) -> None:
    if radius < 1:
        raise ValidationError(f"Radius must be >= 1; got {radius}")


def filters_catalog() -> dict:
    """The `/api/filters` payload (backend/app.py:139-184)."""
    return {
        "gaussian": {
            "name": GAUSSIAN.display_name,
            "description": GAUSSIAN.description,
            "parameters": {
                "sigma": {
                    "type": "float",
                    "default": config.DEFAULT_SIGMA,
                    "range": list(config.SIGMA_RANGE),
                },
                "radius": {
                    "type": "int",
                    "default": config.DEFAULT_RADIUS,
                    "range": list(config.RADIUS_RANGE),
                },
                "level": {"type": "int", "default": 1, "options": [1, 2]},
            },
            "optimization_levels": GAUSSIAN.level_catalog,
        },
        "box": {
            "name": BOX.display_name,
            "description": BOX.description,
            "parameters": {
                "radius": {
                    "type": "int",
                    "default": config.DEFAULT_RADIUS,
                    "range": list(config.RADIUS_RANGE),
                },
                "level": {"type": "int", "default": 1, "options": [1, 2]},
            },
            "optimization_levels": BOX.level_catalog,
        },
        "sobel": {
            "name": SOBEL.display_name,
            "description": SOBEL.description,
            "parameters": {
                "level": {"type": "int", "default": 2, "options": [1, 2]},
            },
            "optimization_levels": SOBEL.level_catalog,
        },
    }
