"""A (dp, sp) mesh of devices for the multi-device paths: the port of the
JAX package's `parallel/mesh.py`.

Axes:
    dp -- data parallel over a batch of images
    sp -- spatial parallel over image rows (halo rows copied between shards)

The port is single-process, as the JAX package is single-controller: one
process holds the mesh and drives every shard, and halo rows move as plain
tensor copies (a copy within one card, a peer copy between cards).  A mesh
may name one device several times, so one card (or the CPU) can run 4 or 8
shards with real halo exchange, the counterpart of the JAX tests'
`--xla_force_host_platform_device_count=8`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime.device import resolve


@dataclass(frozen=True)
class Mesh:
    """`devices` is a (dp, sp) object array of `torch.device`."""

    devices: np.ndarray
    axis_names: tuple[str, str] = ("dp", "sp")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> tuple[torch.device, ...]:
        """Each device of the mesh once, in mesh order."""
        return tuple(dict.fromkeys(self.devices.ravel().tolist()))


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, devices: list | None = None) -> Mesh:
    """A (dp, sp) mesh over the first `n_devices` of `devices`.

    `devices=None` takes every visible CUDA card.  Without enough of them
    this raises ValueError; it never moves to the CPU on its own.  The CPU
    is used only where the caller names it
    (`devices=[torch.device("cpu")] * 8`).  A list may name one device
    several times.

    If dp and sp are not given, dp is the largest power of two <= sqrt(n)
    that divides n (8 -> (2, 4), 4 -> (2, 2), 2 -> (1, 2)).
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    else:
        devices = [resolve(d) for d in devices]
    n = n_devices or len(devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"Requested {n} devices but only {len(devices)} present")
    if dp is None and sp is None:
        dp = 1
        while n % (dp * 2) == 0 and dp * 2 <= math.isqrt(n):
            dp *= 2
        sp = n // dp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(dp, sp))
