"""The native codec tier: PNG encode and decode, the upload decoders in
`native/src` (JPEG, GIF, BMP, PSD, HDR, PIC, PNM, TGA), and the JPEG and
HDR writers.

The same functions as the JAX package's binding (gpu_image_processing_tpu/
utils/native_codec.py).  The decoders and writers are the symbols of
`gip_jpeg.cpp` and `gip_formats.cpp`, built from those sources by
ops/cuda/build.py with the host C++ compiler at first use.  The PNG tier,
`native/src/gip_codec.cpp` there (which includes `<zlib.h>`), is here two
halves: the scanline loops in `ops/cuda/png_codec.cpp` (host C++, built the
same way), and zlib's deflate, inflate and CRC through Python's `zlib`
module, the library gip_codec.cpp links; its chunk parsing and pixel
assembly are below.  A failed build raises with the compiler's stderr.

Each decoder returns an (H, W, C) uint8 array (float32 or uint16 for the
wide ones), or None when the decoder rejects the bytes (malformed,
truncated, over the pixel cap of `gip_limits.h`, or a variant it does not
read, such as arithmetic-coded JPEG or RLE BMP).  The decoders `malloc` their
output; it is released here with the C library's `free`.
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
_SIGNATURES = {
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
    "gip_jpeg_encode": [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _BUF,
                        ctypes.POINTER(ctypes.c_size_t)],
    "gip_hdr_write": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int],
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
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
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


def hdr_write(path: str, img: np.ndarray) -> bool:
    """Write HWC uint8 as Radiance HDR (new-RLE scanlines), inverting the
    decoder's gamma-2.2 tone map; True on success."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    return load().gip_hdr_write(path.encode(),
                                img.ctypes.data_as(ctypes.c_char_p),
                                h, w, c) == 0


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

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: The decode-bomb cap of `native/src/gip_limits.h` (kGipMaxDecodePixels).
MAX_DECODE_PIXELS = 178956970
#: The longest IDAT chunk the encoder writes (gip_codec.cpp png_assemble).
_MAX_IDAT = 1 << 30
#: Samples a pixel of each PNG colour type, and the depths it allows (PNG
#: specification, table 11.1).
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
#: The colour type the encoder writes for each channel count.
_ENCODE_COLOUR = {1: 0, 2: 4, 3: 2, 4: 6}
#: Adam7 passes: (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

_PNG_SIGNATURES = {
    "gip_png_filter_rows": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "gip_png_unfilter": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                         ctypes.c_int64, ctypes.c_int],
}


def png_lib() -> ctypes.CDLL:
    """The PNG tier's scanline library (`ops/cuda/png_codec.cpp`), built
    first if needed."""
    return build.load_host("png_codec", _PNG_SIGNATURES)


def png_unfilter(raw, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """(height, row_bytes) uint8 from `height` inflated scanlines of 1 filter
    byte and `row_bytes` bytes (any buffer); `bpp` is the filter's unit,
    max(1, bits a pixel // 8), through the rows specialized by filter type.
    Raises ValueError naming the first row of an unknown filter type."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (row_bytes + 1) or bpp < 1:
        raise ValueError(f"{src.size} scanline bytes for {height} rows of "
                         f"{row_bytes} at {bpp} bytes a pixel")
    out = np.empty((height, row_bytes), np.uint8)
    code = png_lib().gip_png_unfilter(src.ctypes.data, out.ctypes.data,
                                      height, row_bytes, bpp)
    if code != 0:
        raise ValueError(f"unknown PNG filter type in row {-code - 1}")
    return out


def png_filter_rows(img: np.ndarray, level: int = 1) -> np.ndarray:
    """HWC uint8 -> the (H, 1 + W * C) scanline records the encoder
    deflates: filter type 1 (Sub) at level <= 1, 0 (None) above."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"cannot filter an image of shape {img.shape}")
    h, w, c = img.shape
    out = np.empty((h, w * c + 1), np.uint8)
    if png_lib().gip_png_filter_rows(img.ctypes.data, h, w, c, level,
                                     out.ctypes.data) != 0:
        raise ValueError(f"cannot filter an image of shape {img.shape}")
    return out


def _png_chunk(kind: bytes, payload) -> list:
    """The parts of one chunk: length, type, payload, CRC."""
    crc = zlib.crc32(payload, zlib.crc32(kind))
    return [struct.pack(">I", len(payload)), kind, payload,
            struct.pack(">I", crc)]


def png_encode(img: np.ndarray, level: int = 1) -> Optional[bytes]:
    """HWC uint8 (C in 1, 3, 4; also 2, as grey + alpha) -> PNG bytes, or
    None for an empty image or another channel count.

    The bytes `gip_png_encode` writes: at level <= 1 the Sub filter and
    deflate at level 1 with the run-length strategy (Z_RLE, window 15,
    memory level 8), the serving fast path; at level >= 2 filter None and
    zlib's compress2 at `level`; IDAT chunks of at most 2^30 bytes.  Two
    channels, which gip_png_encode refuses (the JAX package then writes them
    with Pillow), are colour type 4 here.
    """
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _ENCODE_COLOUR or img.size == 0:
        return None
    h, w, c = img.shape
    lines = png_filter_rows(img, level)
    try:
        if level <= 1:
            deflater = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
            data = deflater.compress(lines) + deflater.flush()
        else:
            data = zlib.compress(lines, level)
    except zlib.error:
        return None
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _ENCODE_COLOUR[c], 0, 0, 0)
    parts = [PNG_SIGNATURE, *_png_chunk(b"IHDR", ihdr)]
    view = memoryview(data)
    for i in range(0, max(len(data), 1), _MAX_IDAT):
        parts += _png_chunk(b"IDAT", view[i:i + _MAX_IDAT])
    return b"".join(parts + _png_chunk(b"IEND", b""))


def png_unpack(packed: np.ndarray, width: int, samples: int,
               depth: int) -> np.ndarray:
    """(rows, row_bytes) unfiltered bytes -> (rows, width, samples) values at
    their own depth (big-endian uint16 pairs to uint16 at depth 16)."""
    rows = packed.shape[0]
    if depth == 16:
        return packed[:, :width * samples * 2].view(">u2").astype(
            np.uint16).reshape(rows, width, samples)
    if depth == 8:
        return packed[:, :width * samples].reshape(rows, width, samples)
    bits = np.unpackbits(packed, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    values = (bits.reshape(rows, width, depth) * weights).sum(
        axis=2, dtype=np.uint8)
    return values[:, :, None]


def png_decode(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> HWC uint8, or None wherever `gip_png_decode` refuses
    them (the caller then tries the next tier).

    Every colour type and depth (1-16) and Adam7, reduced as stb_image
    reduces them (gip_codec.cpp:247-255): 16-bit samples keep their high
    byte; grey below 8 bits scales to the full range; palettes expand
    through PLTE to RGB, or to RGBA when a tRNS chunk gives alpha; grey
    and RGB keep their channels (1, 2, 3 or 4).  Chunks are parsed as
    gip_png_decode parses them: CRCs are not checked, the chunks after IEND
    are not read, and the image data must inflate to exactly the bytes its
    header declares.
    """
    if len(data) < 45 or not data.startswith(PNG_SIGNATURE):
        return None
    n = len(data)
    width = height = depth = samples = pal_count = 0
    colour = -1
    interlace = 0
    palette = np.zeros((256, 3), np.uint8)
    pal_alpha = np.full(256, 255, np.uint8)
    have_trns = False
    idat = []
    pos = 8
    while pos + 12 <= n:
        length, kind = struct.unpack_from(">I4s", data, pos)
        if pos + 12 + length > n:
            return None
        payload = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            if length != 13:
                return None
            width, height, depth, colour, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if not width or not height or width * height > MAX_DECODE_PIXELS:
                return None
            if interlace not in (0, 1) or colour not in SAMPLES:
                return None
            if depth not in DEPTHS[colour]:
                return None
            samples = SAMPLES[colour]
        elif kind == b"PLTE":
            if length % 3 or length > 256 * 3:
                return None
            pal_count = length // 3
            palette[:pal_count] = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            pal_alpha[:pal_count] = 255
        elif kind == b"tRNS":
            if colour == 3:
                if length > pal_count:
                    return None
                pal_alpha[:length] = np.frombuffer(payload, np.uint8)
                have_trns = True
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if not width or not samples or not any(idat) or (colour == 3
                                                     and not pal_count):
        return None

    bits = depth * samples
    fbpp = max(1, bits // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    geometry = []   # (x0, y0, dx, dy, pass width, pass height, row bytes)
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            geometry.append((x0, y0, dx, dy, pw, ph, (pw * bits + 7) // 8))
    total = sum(ph * (rb + 1) for *_, ph, rb in geometry)
    # zlib's uncompress into a buffer of `total` bytes, as gip_png_decode
    # inflates: the stream must end, and fill it exactly.  The output is
    # bounded, so a small image cannot inflate to gigabytes.
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat), total + 1)
    except zlib.error:
        return None
    if len(raw) != total or not inflater.eof:
        return None

    if not interlace and depth == 8 and colour != 3:
        # The serving path: the unfiltered rows are the image.
        try:
            packed = png_unfilter(raw, height, geometry[0][-1], fbpp)
        except ValueError:
            return None
        return packed.reshape(height, width, samples)
    out_c = (4 if have_trns else 3) if colour == 3 else samples
    out = np.empty((height, width, out_c), np.uint8)
    offset = 0
    for x0, y0, dx, dy, pw, ph, row_bytes in geometry:
        size = ph * (row_bytes + 1)
        try:
            packed = png_unfilter(memoryview(raw)[offset:offset + size], ph,
                                  row_bytes, fbpp)
        except ValueError:
            return None
        offset += size
        values = png_unpack(packed, pw, samples, depth)
        if depth == 16:
            values = (values >> 8).astype(np.uint8)
        elif colour == 0 and depth < 8:
            values = values * np.uint8(255 // ((1 << depth) - 1))
        if colour == 3:
            index = values[..., 0]
            if int(index.max()) >= pal_count:
                return None
            values = palette[index]
            if have_trns:
                values = np.concatenate(
                    [values, pal_alpha[index][..., None]], axis=2)
        out[y0::dy, x0::dx] = values
    return out
