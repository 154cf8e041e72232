"""Performance metrics triplet {time_ms, bandwidth_gbps, fps}.

Reproduces the reference's modeled (not measured) bandwidth computation:
blurs assume ``bytes = W*H*C*4`` (two passes x read+write), Sobel assumes
``W*H*C*2``; GB/s uses 1024^3 (GiB); ``fps = 1000/time_ms``
(cuda_lib/src/image_filters.cu:905-909,1094-1096,1711-1715).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PerformanceMetrics:
    """Mirror of `PerformanceMetrics` (cuda_lib/include/image_filters.h:17-21)."""

    time_ms: float
    bandwidth_gbps: float
    fps: float

    def as_dict(self) -> dict[str, float]:
        return {
            "time_ms": float(self.time_ms),
            "bandwidth_gbps": float(self.bandwidth_gbps),
            "fps": float(self.fps),
        }


def compute_metrics(
    time_ms: float, width: int, height: int, channels: int, bytes_factor: int
) -> PerformanceMetrics:
    bytes_transferred = width * height * channels * bytes_factor
    if time_ms <= 0.0:
        time_ms = 1e-6  # guard: sub-microsecond measurements
    bandwidth_gbps = (bytes_transferred / (time_ms / 1000.0)) / (1024.0**3)
    fps = 1000.0 / time_ms
    return PerformanceMetrics(
        time_ms=float(time_ms), bandwidth_gbps=float(bandwidth_gbps), fps=float(fps)
    )
