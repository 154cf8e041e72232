"""What the card and the host are, and what the run must refuse.

A run measures only on CUDA cards: with fewer than the cell asks for it
raises `NoChip`, and `run.py` exits without a result.  Every result names
the card and its power limit; the SM clock, power draw and temperature are
sampled beside the window, so that two runs can be told comparable.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

#: Top-level module names that no run may load: JAX and the JAX package
#: the port was made from.  Compared whole, so the port's own name, which
#: begins with the JAX package's, does not match.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax",
                               "gpu_image_processing_tpu"})


class NoChip(RuntimeError):
    """The run cannot measure here."""


class Forbidden(RuntimeError):
    """The run loaded a module it may not."""


def require_cards(count: int) -> None:
    """Raise `NoChip` unless CUDA is available with `count` cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false: no CUDA card, no "
                     "measurement")
    found = torch.cuda.device_count()
    if found < count:
        raise NoChip(f"the cell asks for {count} cards; {found} found")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def check_build_dir(root: Path) -> Path:
    """The port's kernel build directory, which has to lie inside the
    checkout so that only a checkout's first run builds; raises if it lies
    elsewhere."""
    from gpu_image_processing_tpu_torch.ops.cuda import build

    build_dir = Path(build.BUILD_DIR).resolve()
    if not build_dir.is_relative_to(root.resolve()):
        raise RuntimeError(f"the port builds into {build_dir}, outside the "
                           f"checkout {root}: a cache there never hits")
    return build_dir


def smi(fields: str) -> list[str]:
    """One `nvidia-smi --query-gpu` reading of the first card, or the error
    in place of each field."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return [v.strip() for v in out.stdout.strip().split(",")]
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"unread ({exc.__class__.__name__})"] * len(fields.split(","))


def device_info(count: int) -> dict:
    """The result's `device` block: platform, the card's name, the cards
    used."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def describe_host() -> str:
    """The earlier line that names the card, its power limit and the
    host."""
    import torch

    name, limit = smi("name,power.limit")
    return (f"portbench: card {name!r} x{torch.cuda.device_count()} "
            f"(torch says {torch.cuda.get_device_name(0)!r}), power limit "
            f"{limit} W, host CPUs {os.cpu_count()}, torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")


def sample_clocks() -> str:
    """SM clock (MHz), power draw (W) and temperature (C) now."""
    sm, draw, temp = smi("clocks.sm,power.draw,temperature.gpu")
    return f"sm {sm} MHz, draw {draw} W, {temp} C"
