"""Write the upload fixture set of tests/test_torch_formats.py and
chip_smoke.py, and `expected.npz`: the (H, W, 3) pixels the JAX package
decodes from each file.

Usage, from the root of the repository (needs a C++ compiler, zlib's
header, Pillow and the JAX package):

    python3 tests/data/torch_formats/generate.py

The reference is the JAX package's own codec, unedited: its native tier
(Pillow switched off, `GIP_NATIVE_LIB` naming a library built here from
`native/src`), which is what it serves every format with, PNG included,
since it tries `gip_png_decode` first.  The images are small and smooth so
that the set stays under 100 KB.
"""

from __future__ import annotations

import base64
import io
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
SEED = 2024
H, W = 24, 32

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(ROOT))

from PIL import Image  # noqa: E402

from gpu_image_processing_tpu.utils import image as jax_image  # noqa: E402
from gpu_image_processing_tpu.utils import native_codec as jax_native  # noqa: E402
from tests.test_native_formats import (  # noqa: E402
    _hdr_bytes,
    _pic_bytes_uncompressed,
    _png_bytes,
    _psd_bytes,
)


def _smooth(rng: np.random.Generator, c: int = 3) -> np.ndarray:
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(x / 9 + k) * np.cos(y / 7 - k)
                     for k in range(c)], axis=-1)
    base[H // 4:H // 2, W // 3:W // 2] = 30
    return np.clip(base + rng.integers(0, 2, (H, W, c)), 0, 255).astype(np.uint8)


def _pil(arr: np.ndarray, fmt: str, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kwargs)
    return buf.getvalue()


def fixtures(rng: np.random.Generator) -> dict[str, bytes]:
    rgb = _smooth(rng)
    grey = _smooth(rng, 1)[..., 0]
    rgba = np.dstack([rgb, _smooth(rng, 1)])
    bgra = rgba[:, :, [2, 1, 0, 3]]
    bmp32 = (b"BM" + (54 + bgra.size).to_bytes(4, "little") + bytes(4)
             + (54).to_bytes(4, "little") + (40).to_bytes(4, "little")
             + W.to_bytes(4, "little") + (-H).to_bytes(4, "little", signed=True)
             + (1).to_bytes(2, "little") + (32).to_bytes(2, "little")
             + bytes(4) + bgra.size.to_bytes(4, "little") + bytes(16)
             + bgra.tobytes())
    mant = np.clip(rgb // 2 + 64, 0, 255).astype(np.uint8)
    rgbe = np.dstack([mant, np.full((H, W, 1), 128, np.uint8)])
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    gif = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=64)
    buf = io.BytesIO()
    gif.save(buf, format="GIF")
    return {
        "jpeg_420.jpg": _pil(rgb, "JPEG", quality=90, subsampling=2),
        "jpeg_444.jpg": _pil(rgb, "JPEG", quality=90, subsampling=0),
        "jpeg_grey.jpg": _pil(grey, "JPEG", quality=90),
        "image.gif": buf.getvalue(),
        "bmp24.bmp": _pil(rgb, "BMP"),
        "bmp32.bmp": bmp32,
        "image.psd": _psd_bytes(rgb, compression=1),
        "image.hdr": _hdr_bytes(rgbe, new_rle=True),
        "image.pic": _pic_bytes_uncompressed(rgb),
        "grey.pgm": _pil(grey, "PPM"),
        "rgb.ppm": _pil(rgb, "PPM"),
        "rle.tga": _pil(rgb, "TGA", compression="tga_rle"),
        "png_1bit.png": _png_bytes(grey >= 128, 1, 0),
        "png_4bit.png": _png_bytes(rgb[..., 0] >> 4, 4, 3, palette=palette),
        "png_16bit.png": _png_bytes(grey.astype(np.uint16) * 131, 16, 0),
        "png_interlaced.png": _png_bytes(rgb, 8, 2, interlace=1),
    }


def _reference_lib(out_dir: str) -> str:
    src = ROOT / "native" / "src"
    lib = os.path.join(out_dir, "libgip_codec.so")
    subprocess.run(["c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", lib,
                    str(src / "gip_codec.cpp"), str(src / "gip_formats.cpp"),
                    str(src / "gip_jpeg.cpp"), "-lz"], check=True)
    return lib


def main() -> None:
    files = fixtures(np.random.default_rng(SEED))
    expected = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["GIP_NATIVE_LIB"] = _reference_lib(tmp)
        jax_native._LIB, jax_native._SEARCHED = None, False
        jax_image.PIL_AVAILABLE = False
        for name, data in files.items():
            url = "data:;base64," + base64.b64encode(data).decode()
            expected[name] = jax_image.decode_base64_image(url)
    for name, data in files.items():
        (HERE / name).write_bytes(data)
    np.savez_compressed(HERE / "expected.npz", **expected)
    total = sum(p.stat().st_size for p in HERE.iterdir())
    print(f"{len(files)} fixtures and expected.npz, {total} bytes in all")


if __name__ == "__main__":
    main()
