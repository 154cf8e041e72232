"""Image files by extension: the loaders and writers of the image-file CLI
(tools/filter_image.py).

The counterpart of the JAX package's `scripts/filter_image.py`
`load_image`, `save_image` and `load_frames`, which write and read through
its native codec (`gip_ppm_write`, `gip_ppm_read`, `gip_bmp_write`,
`gip_tga_write`, `gip_tga_read` of native/src/gip_codec.cpp).  Here:

* writers: `.png` through `native_codec.png_encode` (Sub filter, zlib
  level 1 with run-length matching); `.ppm`/`.pgm`, `.bmp`, `.tga` and
  `.hdr` through `native_codec.write_file`, the same gip_*_write functions
  of the same library; `.jpg`/`.jpeg` through `native_codec.jpeg_encode`
  at quality 90, with the JAX CLI's channel rule for a host without
  Pillow.  A channel count a writer refuses raises ValueError; any other
  extension raises too: the JAX CLI's last tier writes it with Pillow,
  which has no counterpart here.
* readers: `.ppm`/`.pgm` and `.tga` from the file's bytes through the
  native decoders (`pnm_decode`, `tga_decode`; gip_tga_read is
  gip_tga_decode over the file), alpha stripped as the JAX CLI strips it;
  every other file through `load_image_file`, whose reductions are the JAX
  package's Pillow tier's.
"""

from __future__ import annotations

import os

import numpy as np

from . import native_codec
from .image import load_image_file

#: The JPEG quality of `native_codec.jpeg_encode`'s default, which the JAX
#: CLI writes with.
JPEG_QUALITY = 90
WRITERS = (".png", ".ppm", ".pgm", ".bmp", ".tga", ".hdr", ".jpg", ".jpeg")
#: The extensions a gip_<kind>_write function writes to the file.
_FILE_WRITERS = {".ppm": "ppm", ".pgm": "ppm", ".bmp": "bmp", ".tga": "tga",
                 ".hdr": "hdr"}


def save_image(path: str, arr: np.ndarray) -> None:
    """Write `arr` (HWC uint8) in the format `path`'s extension names."""
    ext = os.path.splitext(path)[1].lower()
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    kind = _FILE_WRITERS.get(ext)
    if kind is not None:
        code = native_codec.write_file(kind, path, arr)
        if code == 1:
            raise ValueError(f"gip_{kind}_write does not write an image of "
                             f"shape {arr.shape} (see native_codec.write_file)")
        if code:
            raise OSError(f"native {kind.upper()} write failed (code {code}): "
                          f"{path}")
        return
    if ext == ".png":
        data = native_codec.png_encode(arr)
        if data is None:
            raise RuntimeError(f"cannot write a PNG of shape {arr.shape}")
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
