"""Example: filtering a batch over a mesh of devices.

A mesh may name one device several times, so four shards run on one card
(or, with `--device cpu`, on the CPU): the batch is split over the `dp`
axis and image rows over `sp`, each shard getting its neighbours' halo rows
as tensor copies, one kernel launch a shard.

    python -m gpu_image_processing_tpu_torch.examples.sharded_batch [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..ops.weights import gaussian_kernel_f32
from ..parallel.mesh import make_mesh
from ..parallel.spatial import make_sharded_filter
from ..runtime.device import resolve


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)
    device = resolve(args.device)

    mesh = make_mesh(4, devices=[device] * 4)
    dp, sp = mesh.devices.shape
    print(f"mesh: dp={dp} x sp={sp} over {mesh.size} shards of {device}")

    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, size=(2 * dp, 64 * sp, 320, 3), dtype=np.uint8)
    step = make_sharded_filter(mesh, "gaussian", radius=3)
    out = step(batch, gaussian_kernel_f32(3, 2.0))
    print(f"sharded result: {tuple(out.shape)} on {out.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
