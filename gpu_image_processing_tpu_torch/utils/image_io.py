"""Image files by extension: the loaders and writers of the image-file CLI
(tools/filter_image.py).

The counterpart of the JAX package's `scripts/filter_image.py`
`load_image`, `save_image` and `load_frames`, which write and read through
its native codec (`gip_ppm_write`, `gip_ppm_read`, `gip_bmp_write`,
`gip_tga_write`, `gip_tga_read` of native/src/gip_codec.cpp).  Here:

* writers: `.png` through `native_codec.png_encode` (Sub filter, zlib
  level 1 with run-length matching); `.ppm`/`.pgm`, `.bmp` and `.tga` in
  numpy, byte for byte what the gip_*_write functions write; `.hdr`
  through `native_codec.hdr_write`; `.jpg`/`.jpeg` through
  `native_codec.jpeg_encode` at quality 90, with the JAX CLI's channel rule
  for a host without Pillow.  Any other extension raises: the JAX CLI's
  last tier writes it with Pillow, which has no counterpart here.
* readers: `.ppm`/`.pgm` and `.tga` from the file's bytes through the
  native decoders (`pnm_decode`, `tga_decode`; gip_tga_read is
  gip_tga_decode over the file), alpha stripped as the JAX CLI strips it;
  every other file through `load_image_file`, whose reductions are the JAX
  package's Pillow tier's.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import native_codec
from .image import load_image_file

#: The JPEG quality of `native_codec.jpeg_encode`'s default, which the JAX
#: CLI writes with.
JPEG_QUALITY = 90
WRITERS = (".png", ".ppm", ".pgm", ".bmp", ".tga", ".hdr", ".jpg", ".jpeg")


def _hwc(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return arr[:, :, None] if arr.ndim == 2 else arr


def ppm_bytes(arr: np.ndarray) -> bytes:
    """`gip_ppm_write`: P5 for one channel, P6 for three, maxval 255."""
    arr = _hwc(arr)
    h, w, c = arr.shape
    if c not in (1, 3):
        raise ValueError(f"PPM/PGM takes 1 or 3 channels, not {c}")
    return f"P{5 if c == 1 else 6}\n{w} {h}\n255\n".encode() + arr.tobytes()


def bmp_bytes(arr: np.ndarray) -> bytes:
    """`gip_bmp_write`: 24-bit BGR rows, bottom-up, each padded to 4 bytes;
    grey is replicated and alpha dropped."""
    arr = _hwc(arr)
    h, w, c = arr.shape
    if c not in (1, 3, 4) or not h or not w:
        raise ValueError(f"BMP takes 1, 3 or 4 channels, not shape {arr.shape}")
    row = (w * 3 + 3) & ~3
    if 54 + row * h > 0xFFFFFFFF:
        raise ValueError(f"a {w}x{h} image is too large for a BMP")
    rgb = np.repeat(arr, 3, axis=2) if c == 1 else arr[:, :, :3]
    pixels = np.zeros((h, row), np.uint8)
    pixels[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<2sIIIIiiHHII16x", b"BM", 54 + row * h, 0, 54, 40,
                         w, h, 1, 24, 0, row * h)
    return header + pixels.tobytes()


def tga_bytes(arr: np.ndarray) -> bytes:
    """`gip_tga_write`: uncompressed, top-down; type 3 (grey) for one
    channel, else type 2 with BGR or BGRA pixels."""
    arr = _hwc(arr)
    h, w, c = arr.shape
    if c not in (1, 3, 4) or not 0 < w <= 0xFFFF or not 0 < h <= 0xFFFF:
        raise ValueError(f"TGA takes 1, 3 or 4 channels and sides up to "
                         f"65535, not shape {arr.shape}")
    header = bytearray(18)
    header[2] = 3 if c == 1 else 2
    header[12:16] = struct.pack("<HH", w, h)
    header[16] = 8 * c
    header[17] = 0x20 | (8 if c == 4 else 0)
    pixels = arr if c == 1 else arr[:, :, [2, 1, 0, 3][:c]]
    return bytes(header) + np.ascontiguousarray(pixels).tobytes()


def save_image(path: str, arr: np.ndarray) -> None:
    """Write `arr` (HWC uint8) in the format `path`'s extension names."""
    ext = os.path.splitext(path)[1].lower()
    arr = _hwc(arr)
    if ext == ".hdr":
        if not native_codec.hdr_write(path, arr):
            raise RuntimeError(f"native HDR write failed: {path}")
        return
    if ext == ".png":
        data = native_codec.png_encode(arr)
        if data is None:
            raise RuntimeError(f"cannot write a PNG of shape {arr.shape}")
    elif ext in (".ppm", ".pgm"):
        data = ppm_bytes(arr)
    elif ext == ".bmp":
        data = bmp_bytes(arr)
    elif ext == ".tga":
        data = tga_bytes(arr)
    elif ext in (".jpg", ".jpeg"):
        if arr.shape[2] not in (1, 3):
            raise RuntimeError(
                f"cannot write {arr.shape[2]}-channel image as JPEG "
                "(native encoder supports grayscale/RGB only)")
        data = native_codec.jpeg_encode(arr, JPEG_QUALITY)
        if data is None:
            raise RuntimeError(f"native JPEG write failed: {path}")
    else:
        raise ValueError(
            f"cannot write {ext or 'a file without an extension'}: the "
            f"writers are {', '.join(WRITERS)} (other formats need Pillow)")
    with open(path, "wb") as f:
        f.write(data)


def load_image(path: str) -> np.ndarray:
    """Read an image file as HWC uint8: 1 channel (grey) or 3, alpha
    stripped as the reference CLI strips it (test_real_image.cu:122-125)."""
    with open(path, "rb") as f:
        data = f.read()
    ext = os.path.splitext(path)[1].lower()
    arr = None
    if ext in (".ppm", ".pgm"):
        arr = native_codec.pnm_decode(data)
    elif ext == ".tga":
        arr = native_codec.tga_decode(data)
    if arr is None:
        arr = load_image_file(data)[0]
    if arr.shape[2] == 4:
        arr = np.ascontiguousarray(arr[:, :, :3])
    return arr


def load_frames(path: str) -> tuple[np.ndarray, list[int], str]:
    """(N, H, W, 3) frames of a GIF, their delays in ms, and the tier
    ("native"): every frame composited, as `gif_frames` decodes them."""
    with open(path, "rb") as f:
        res = native_codec.gif_frames(f.read())
    if res is None:
        raise ValueError(f"{path}: not a GIF the native decoder reads")
    frames, delays = res
    return frames[:, :, :, :3], delays, "native"
