"""Example: deep-profile a filter and print its per-kernel rows.

On the card the rows come from a torch.profiler trace of the served call
(`duration_source` torch_profiler_trace), under the hand kernels' own
names; on the CPU the profile is the wall time (wall_timing).

    python -m gpu_image_processing_tpu_torch.examples.profile_kernels [gaussian|box|sobel] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..profiling.profiler import get_common_metrics, profile_filter
from ..runtime.dispatch import FilterRuntime


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("filter", nargs="?", default="gaussian",
                        choices=["gaussian", "box", "sobel"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)
    runtime = FilterRuntime(args.device)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)

    kwargs = {"gaussian": dict(sigma=2.0, radius=3),
              "box": dict(radius=5), "sobel": {}}[args.filter]
    deep = profile_filter(runtime, img, args.filter, 2, **kwargs)
    common = get_common_metrics(deep)

    print(f"filter: {args.filter} L2 on {img.shape} ({runtime.device})")
    print(f"duration_source: {deep.get('duration_source')}")
    print(f"time_ms: {deep['total_kernel_duration_ms']:.4f}")
    for name, ms in deep.get("kernel_durations_ms", {}).items():
        print(f"  {ms:8.4f} ms  {name[:100]}")
    for key in ("memory_throughput_gbps", "dram_throughput_pct"):
        if key in common:
            print(f"{key}: {common[key]:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
