"""Request/response schemas for the REST API, as dataclasses.

Field-for-field the JAX package's pydantic models (gpu_image_processing_tpu/
server/schemas.py, after backend/app.py:46-63), with the same defaults, so
reference clients work unchanged.  The card's machine has no pydantic, so
`FilterRequest.from_json` validates by hand what pydantic's lax mode
accepts for these fields: a missing or ill-typed field raises
`SchemaError`, which the server answers with 422; unknown fields are
ignored.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

from ..core import config


class SchemaError(ValueError):
    """A request body that does not fit the schema (HTTP 422)."""


def _as_int(name: str, value: Any) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value.strip())
        except ValueError:
            pass
    raise SchemaError(f"{name}: expected an integer, got {value!r}")


def _as_float(name: str, value: Any) -> float:
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    if isinstance(value, str):
        try:
            out = float(value.strip())
        except ValueError:
            pass
        else:
            if math.isfinite(out):
                return out
    raise SchemaError(f"{name}: expected a number, got {value!r}")


def _as_bool(name: str, value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.strip().lower() in (
            "true", "false", "1", "0", "yes", "no", "on", "off"):
        return value.strip().lower() in ("true", "1", "yes", "on")
    raise SchemaError(f"{name}: expected a boolean, got {value!r}")


def _as_str(name: str, value: Any) -> str:
    if isinstance(value, str):
        return value
    raise SchemaError(f"{name}: expected a string, got {value!r}")


@dataclass
class FilterRequest:
    image: str                      # base64 encoded (data-URL prefix ok)
    filter: str                     # "gaussian" | "box" | "sobel"
    level: int = 1                  # 1=naive, 2=optimized, 4=advanced
    sigma: float | None = config.DEFAULT_SIGMA
    radius: int | None = config.DEFAULT_RADIUS
    enable_profiling: bool = False  # deep profile of each level (or the batch)

    @classmethod
    def from_json(cls, body: Any) -> "FilterRequest":
        if not isinstance(body, dict):
            raise SchemaError(f"expected a JSON object, got {type(body).__name__}")
        missing = [k for k in ("image", "filter") if k not in body]
        if missing:
            raise SchemaError(f"missing field(s): {', '.join(missing)}")
        fields: dict[str, Any] = {
            "image": _as_str("image", body["image"]),
            "filter": _as_str("filter", body["filter"]),
        }
        if "level" in body:
            fields["level"] = _as_int("level", body["level"])
        for name, conv in (("sigma", _as_float), ("radius", _as_int)):
            if name in body:
                fields[name] = (None if body[name] is None
                                else conv(name, body[name]))
        if "enable_profiling" in body:
            fields["enable_profiling"] = _as_bool("enable_profiling",
                                                  body["enable_profiling"])
        return cls(**fields)


@dataclass
class FilterResponse:
    processed_image: str
    metrics: dict[str, Any]
    info: dict[str, Any]

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class AllLevelsResponse:
    original_image: str
    results: dict[str, FilterResponse]   # "level_1", "level_2", ...
    image_info: dict[str, Any]
    profiling_available: bool = False

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
