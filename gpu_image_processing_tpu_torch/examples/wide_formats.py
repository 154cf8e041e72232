"""Example: the wide-output loaders (the stbi_load_16 / stbi_loadf analogs).

Builds a 16-bit PNG and a Radiance HDR file in memory, loads them at full
precision (`decode_file_16`: native 16-bit samples; `decode_file_float`:
linear radiance, no tone map), then filters the 16-bit image's high byte
with the API on the chosen device.

    python -m gpu_image_processing_tpu_torch.examples.wide_formats [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import struct
import zlib

import numpy as np

from ..api import filters as api
from ..runtime.dispatch import FilterRuntime
from ..utils.image import decode_file_16, decode_file_float


def png16(arr16: np.ndarray) -> bytes:
    """A 16-bit RGB PNG (filter None rows)."""
    h, w, _ = arr16.shape
    raw = b"".join(b"\x00" + arr16[y].astype(">u2").tobytes()
                   for y in range(h))

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def hdr(rgbe: np.ndarray) -> bytes:
    """A flat (old-format) Radiance HDR file."""
    h, w, _ = rgbe.shape
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
    return head.encode() + rgbe.tobytes()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)
    runtime = FilterRuntime(args.device)
    rng = np.random.default_rng(0)

    wide_src = rng.integers(0, 65536, (96, 128, 3))
    a16 = decode_file_16(png16(wide_src))
    print(f"PNG16 -> {a16.dtype} {a16.shape}, range "
          f"[{a16.min()}, {a16.max()}] (native 16-bit samples)")
    if not np.array_equal(a16, wide_src.astype(np.uint16)):
        raise AssertionError("the 16-bit PNG did not load at full precision")

    rgbe = rng.integers(2, 256, (64, 96, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (64, 96))
    f = decode_file_float(hdr(rgbe))
    print(f"HDR   -> {f.dtype} {f.shape}, radiance range "
          f"[{f.min():.3g}, {f.max():.3g}] (linear, no tone map)")

    ldr = (a16 >> 8).astype(np.uint8)
    r = api.gaussian_blur(ldr, sigma=2.0, radius=3, level=2, runtime=runtime)
    print(f"gaussian L2 on the 16-bit image's high byte ({runtime.device}): "
          f"{r['image'].shape}, {r['time_ms']:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
