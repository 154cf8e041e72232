"""The native codec tier: PNG encode and decode, the upload decoders in
`native/src` (JPEG, GIF, BMP, PSD, HDR, PIC, PNM, TGA), and the file
writers (PPM/PGM, BMP, TGA, JPEG, HDR).

The same functions as the JAX package's binding (gpu_image_processing_tpu/
utils/native_codec.py).  They are the symbols of `native/src/gip_codec.cpp`
(PNG on zlib, the PPM, BMP and TGA writers), `gip_jpeg.cpp` and
`gip_formats.cpp`, compiled where they stand into one library by
ops/cuda/build.py with the host C++ compiler at first use, linked against
zlib (`-lz`; the build needs `<zlib.h>` and the library).  A failed build
raises with the compiler's stderr.

Each decoder returns an (H, W, C) uint8 array (float32 or uint16 for the
wide ones), or None when the decoder rejects the bytes (malformed,
truncated, over the pixel cap of `gip_limits.h`, or a variant it does not
read, such as arithmetic-coded JPEG or RLE BMP).  The decoders and encoders
`malloc` their output; it is released here with the C library's `free`
(`gip_free` is `std::free`).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from ..ops.cuda import build

_BUF = ctypes.POINTER(ctypes.c_void_p)
_INT = ctypes.POINTER(ctypes.c_int)
#: (data, len, &buf, &h, &w, &c): every decoder of one image.
_DECODE = [ctypes.c_char_p, ctypes.c_size_t, _BUF, _INT, _INT, _INT]
#: (img, h, w, c, level or quality, &buf, &len): the in-memory encoders.
_ENCODE = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, _BUF, ctypes.POINTER(ctypes.c_size_t)]
#: (path, img, h, w, c): the file writers.
_WRITE = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
          ctypes.c_int]
_SIGNATURES = {
    "gip_png_decode": _DECODE,
    "gip_png_decode16": _DECODE,
    "gip_png_encode": _ENCODE,
    "gip_jpeg_decode": _DECODE,
    "gip_gif_decode": _DECODE,
    "gip_bmp_decode": _DECODE,
    "gip_psd_decode": _DECODE,
    "gip_psd_decode16": _DECODE,
    "gip_hdr_decode": _DECODE,
    "gip_hdr_decodef": _DECODE,
    "gip_pic_decode": _DECODE,
    "gip_pnm_decode": _DECODE,
    "gip_tga_decode": _DECODE,
    "gip_gif_frames_decode": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                              _BUF, _BUF, _INT, _INT, _INT, _INT],
    "gip_jpeg_encode": _ENCODE,
    "gip_hdr_write": _WRITE,
    "gip_ppm_write": _WRITE,
    "gip_bmp_write": _WRITE,
    "gip_tga_write": _WRITE,
}

_libc = ctypes.CDLL(None)
_free = _libc.free
_free.argtypes = [ctypes.c_void_p]
_free.restype = None


def load() -> ctypes.CDLL:
    """The decoder library, built first if needed."""
    return build.load_host(build.DECODERS, _SIGNATURES)


def _take(buf: ctypes.c_void_p, nbytes: int) -> bytes:
    try:
        return ctypes.string_at(buf, nbytes)
    finally:
        _free(buf)


def _hwc(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return img[:, :, None] if img.ndim == 2 else img


def _decode(fn_name: str, data: bytes,
            dtype: np.dtype = np.uint8) -> Optional[np.ndarray]:
    """Shared out-parameter plumbing of the one-image decoders."""
    buf = ctypes.c_void_p()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(load(), fn_name)(data, len(data), ctypes.byref(buf),
                                  ctypes.byref(h), ctypes.byref(w),
                                  ctypes.byref(c))
    if rc != 0:
        return None
    shape = (h.value, w.value, c.value)
    raw = _take(buf, int(np.prod(shape)) * np.dtype(dtype).itemsize)
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def jpeg_decode(data: bytes) -> Optional[np.ndarray]:
    """Baseline (SOF0/1) or progressive (SOF2) 8-bit JPEG -> HWC uint8 (grey
    1 or RGB 3): YCbCr at 4:4:4, 4:2:2, 4:2:0 and 4:1:1, restart markers.
    None for lossless, arithmetic-coded and hierarchical streams."""
    return _decode("gip_jpeg_decode", data)


def jpeg_encode(img: np.ndarray, quality: int = 90) -> Optional[bytes]:
    """HWC uint8 (C in 1 or 3) -> baseline JPEG bytes (4:4:4), or None."""
    img = _hwc(img)
    h, w, c = img.shape
    if c not in (1, 3):
        return None
    buf = ctypes.c_void_p()
    length = ctypes.c_size_t()
    rc = load().gip_jpeg_encode(img.ctypes.data_as(ctypes.c_char_p), h, w, c,
                                quality, ctypes.byref(buf), ctypes.byref(length))
    if rc != 0:
        return None
    return _take(buf, length.value)


def gif_decode(data: bytes) -> Optional[np.ndarray]:
    """GIF87a/89a first frame composited onto the logical screen -> HWC u8
    (RGB, or RGBA when the frame declares a transparent index)."""
    return _decode("gip_gif_decode", data)


def gif_frames(data: bytes, max_frames: int = 0):
    """GIF animation -> (frames, delays): (N, H, W, 4) uint8 RGBA canvases
    composited with disposal semantics, and N per-frame delays in
    milliseconds.  max_frames <= 0 decodes every frame.  None when the
    bytes are not a decodable GIF."""
    buf, dbuf = ctypes.c_void_p(), ctypes.c_void_p()
    n, h, w, c = (ctypes.c_int() for _ in range(4))
    rc = load().gip_gif_frames_decode(
        data, len(data), max_frames, ctypes.byref(buf), ctypes.byref(dbuf),
        ctypes.byref(n), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        return None
    shape = (n.value, h.value, w.value, c.value)
    raw = _take(buf, int(np.prod(shape)))
    delays = np.frombuffer(_take(dbuf, 4 * n.value), dtype=np.int32)
    return np.frombuffer(raw, dtype=np.uint8).reshape(shape), delays.tolist()


def bmp_decode(data: bytes) -> Optional[np.ndarray]:
    """BMP (1/4/8-bit palette, 16/24/32-bit BI_RGB/BI_BITFIELDS) -> HWC u8.
    None for RLE-compressed BMPs."""
    return _decode("gip_bmp_decode", data)


def psd_decode(data: bytes) -> Optional[np.ndarray]:
    """PSD composite image (RGB/grey, 8/16-bit, RAW or PackBits) -> HWC u8."""
    return _decode("gip_psd_decode", data)


def psd_decode16(data: bytes) -> Optional[np.ndarray]:
    """PSD -> HWC uint16: 16-bit planes as stored, 8-bit ones as v * 257."""
    return _decode("gip_psd_decode16", data, np.uint16)


def hdr_decode(data: bytes) -> Optional[np.ndarray]:
    """Radiance HDR (RGBE, old and new RLE) -> HWC u8 RGB through the LDR
    tone map of stb_image (scale 1, gamma 2.2)."""
    return _decode("gip_hdr_decode", data)


def hdr_decodef(data: bytes) -> Optional[np.ndarray]:
    """Radiance HDR -> HWC float32 linear RGB (m * 2^(e - 136)), no tone
    map."""
    return _decode("gip_hdr_decodef", data, np.float32)


def write_file(kind: str, path: str, img: np.ndarray) -> int:
    """Write HWC (or HW) uint8 to `path` through `gip_<kind>_write`, kind in
    hdr, ppm, bmp, tga; its code: 0 on success, 1 for an image it does not
    write (PPM/PGM takes 1 or 3 channels; HDR, BMP and TGA 1, 3 or 4 and no
    empty image, TGA sides up to 65535, BMP files up to 4 GiB), else the
    file could not be opened or written.

    `ppm` writes P5 for one channel, P6 for three; `bmp` 24-bit BGR rows,
    bottom-up, grey replicated and alpha dropped; `tga` uncompressed
    top-down rows, type 3 (grey) or 2 (BGR or BGRA); `hdr` as
    `hdr_write`."""
    img = _hwc(img)
    h, w, c = img.shape
    return getattr(load(), f"gip_{kind}_write")(
        path.encode(), img.ctypes.data_as(ctypes.c_char_p), h, w, c)


def hdr_write(path: str, img: np.ndarray) -> bool:
    """Write HWC uint8 as Radiance HDR (new-RLE scanlines), inverting the
    decoder's gamma-2.2 tone map; True on success."""
    return write_file("hdr", path, img) == 0


def pic_decode(data: bytes) -> Optional[np.ndarray]:
    """Softimage PIC (8-bit packets, uncompressed or mixed RLE) -> HWC u8."""
    return _decode("gip_pic_decode", data)


def pnm_decode(data: bytes) -> Optional[np.ndarray]:
    """Binary PNM (P5 grey, P6 RGB; 8- or 16-bit) -> HWC u8: values as
    stored up to maxval 255, the high byte of 16-bit samples."""
    return _decode("gip_pnm_decode", data)


def tga_decode(data: bytes) -> Optional[np.ndarray]:
    """TGA (truecolour, grey, colour-mapped; RLE; 15/16/24/32 bits a
    pixel) -> HWC u8."""
    return _decode("gip_tga_decode", data)


# -- PNG ----------------------------------------------------------------------


def png_decode(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> HWC uint8 through `gip_png_decode`, or None where it
    refuses them (the caller then tries the next tier).

    Every colour type and depth (1-16) and Adam7, reduced as stb_image
    reduces them: 16-bit samples keep their high byte; grey below 8 bits
    scales to the full range; palettes expand through PLTE to RGB, or to
    RGBA when a tRNS chunk gives alpha; grey and RGB keep their channels
    (1, 2, 3 or 4).  CRCs are not checked, the chunks after IEND are not
    read, and the image data must inflate to exactly the bytes its header
    declares.  Refused: a palette over 256 entries, a tRNS longer than the
    palette (or before it), a palette index past PLTE, an unknown filter
    type, more than `kGipMaxDecodePixels` pixels (gip_limits.h).
    """
    return _decode("gip_png_decode", data)


def png_decode16(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> HWC uint16 through `gip_png_decode16`, the stbi_load_16
    analog, or None where it refuses them (as `png_decode`): 16-bit samples
    as stored; lower depths after the grey range expansion or the palette
    lookup, as v * 257."""
    return _decode("gip_png_decode16", data, np.uint16)


def _png_grey_alpha(img: np.ndarray, level: int) -> Optional[bytes]:
    """An (H, W, 2) image as colour type 4: filter None rows, deflated by
    zlib at `level`, in one IDAT chunk."""
    h, w, _ = img.shape
    lines = np.zeros((h, 1 + 2 * w), np.uint8)
    lines[:, 1:] = img.reshape(h, -1)
    try:
        data = zlib.compress(lines.tobytes(), level)
    except zlib.error:
        return None
    chunks = ((b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 4, 0, 0, 0)),
              (b"IDAT", data), (b"IEND", b""))
    return b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(payload)) + kind + payload
        + struct.pack(">I", zlib.crc32(kind + payload))
        for kind, payload in chunks)


def png_encode(img: np.ndarray, level: int = 1) -> Optional[bytes]:
    """HWC uint8 (C in 1, 3, 4; also 2, as grey + alpha) -> PNG bytes, or
    None for an empty image, another channel count or a level zlib does not
    take.

    `gip_png_encode` writes 1, 3 and 4 channels: at level <= 1 the Sub
    filter and deflate at level 1 with the run-length strategy (Z_RLE), the
    serving fast path; at level >= 2 filter None and zlib's compress2 at
    `level`.  Two channels, which it refuses (the JAX package then writes
    them with Pillow), are colour type 4 here, filter None and zlib at
    `level`.
    """
    img = _hwc(img)
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4) or img.size == 0:
        return None
    h, w, c = img.shape
    if c == 2:
        return _png_grey_alpha(img, level)
    buf = ctypes.c_void_p()
    length = ctypes.c_size_t()
    if load().gip_png_encode(img.ctypes.data_as(ctypes.c_char_p), h, w, c,
                             level, ctypes.byref(buf), ctypes.byref(length)):
        return None
    return _take(buf, length.value)
