"""The explicit device a runtime runs on, and a description of the card.

Nothing here keeps global device state: every runtime object is given its
`torch.device`.  Nothing picks the CPU because no card was found: the CPU
is used only where a caller names it.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device on a host
    without CUDA (never quietly serves from the CPU instead)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise RuntimeError(f"unsupported device {device}")
    return device


def nvidia_smi_name_power(index: int = 0) -> str:
    """`name, power.limit` of card `index`, as nvidia-smi prints them."""
    proc = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip()


def describe(device: torch.device) -> dict:
    """Name, power limit and CUDA version of a CUDA device."""
    device = resolve(device)
    if device.type != "cuda":
        raise RuntimeError(f"describe() needs a cuda device, not {device}")
    return {
        "name": torch.cuda.get_device_name(device),
        "capability": torch.cuda.get_device_capability(device),
        "name_power_limit": nvidia_smi_name_power(device.index),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
