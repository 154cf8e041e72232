"""Image codec: base64 and data URLs <-> numpy HWC uint8, PNG only.

Same contract as the JAX package's helpers (gpu_image_processing_tpu/utils/
image.py, after backend/app.py:66-111): inbound images are normalized so
the serving path always processes RGB (grey, grey+alpha, palette and RGBA
are converted); outbound images are PNG-encoded and returned as a
``data:image/png;base64,`` URL.

The PNG codec is written on the standard library's `zlib`, because the
card's machine has neither Pillow nor the JAX package's native codec.  It
decodes 8-bit, non-interlaced PNGs of every colour type (grey, RGB,
palette, grey+alpha, RGBA) with all five scanline filters, and encodes
with filter type 1 (Sub) at zlib level 1.  Any other upload (JPEG, 1- to
4-bit, 16-bit or interlaced PNG, ...) is refused with an `ImageCodecError`
naming PNG.

Unfiltering the Average and Paeth filters is sequential along a row.  On a
host with nvcc that step runs in the host C++ helper
`ops/cuda/png_unfilter.cpp`, built at first use by ops/cuda/build.py; a
failed build raises.  On a host without nvcc it runs in `unfilter_plain`
(numpy and Python), the helper's plain version, which the tests also use.
`host_unfilter` makes that choice once per process.
"""

from __future__ import annotations

import base64
import binascii
import ctypes
import struct
import zlib

import numpy as np

from ..ops.cuda import build


class ImageCodecError(ValueError):
    pass


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: Samples per pixel of each PNG colour type (palette: one index).
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
#: Decode-bomb guard: the largest image a PNG may declare.
MAX_PIXELS = 1 << 28

# PNG chunk types that cannot change how decoded pixels render; an RGB PNG
# made only of these may pass through as the original image unchanged.
_PNG_NEUTRAL_CHUNKS = frozenset(
    [b"IHDR", b"IDAT", b"IEND", b"tEXt", b"zTXt", b"iTXt", b"tIME", b"pHYs"]
)


def _fail(why: str) -> ImageCodecError:
    return ImageCodecError(f"Failed to decode image: {why}")


# -- unfiltering -------------------------------------------------------------


def unfilter_plain(raw: np.ndarray, height: int, row_bytes: int,
                   bpp: int) -> np.ndarray:
    """(height, row_bytes) uint8 from the inflated scanlines `raw`
    (height * (1 + row_bytes) bytes).  None, Sub and Up run in numpy;
    Average and Paeth byte by byte."""
    lines = raw.reshape(height, row_bytes + 1)
    out = np.empty((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(height):
        kind, line = int(lines[y, 0]), lines[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = line + prev
        elif kind in (3, 4):
            cur = [0] * row_bytes
            up = prev.tolist()
            src = line.tolist()
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 0xFF
            out[y] = cur
        else:
            raise _fail(f"unknown PNG filter type {kind} in row {y}")
        prev = out[y]
    return out


def unfilter_native(raw: np.ndarray, height: int, row_bytes: int,
                    bpp: int) -> np.ndarray:
    """`unfilter_plain` in the host C++ helper (built at first use)."""
    lib = build.load_host("png_unfilter", {"gip_png_unfilter": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int]})
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"{raw.size} scanline bytes for {height} rows of "
                         f"{row_bytes}")
    out = np.empty((height, row_bytes), np.uint8)
    code = lib.gip_png_unfilter(raw.ctypes.data, out.ctypes.data, height,
                                row_bytes, bpp)
    if code != 0:
        raise _fail(f"unknown PNG filter type in row {-code - 1}")
    return out


_HOST_UNFILTER = None


def host_unfilter():
    """The unfilter this host decodes with, chosen once: `unfilter_native`
    where nvcc can build the helper, else `unfilter_plain`."""
    global _HOST_UNFILTER
    if _HOST_UNFILTER is None:
        try:
            build.nvcc_path()
        except RuntimeError:
            _HOST_UNFILTER = unfilter_plain
        else:
            _HOST_UNFILTER = unfilter_native
    return _HOST_UNFILTER


# -- PNG ---------------------------------------------------------------------


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, through IEND."""
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise _fail("truncated PNG chunk")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + payload) != crc:
            raise _fail(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end
    raise _fail("PNG without IEND")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 as stored: C = 1 (grey), 2 (grey+alpha),
    3 (RGB, and palette expanded through PLTE) or 4 (RGBA).  A tRNS chunk
    is ignored: alpha goes when the caller normalizes to RGB."""
    if not data.startswith(_PNG_SIGNATURE):
        raise _fail("only PNG images are supported")
    header = palette = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise _fail("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _SAMPLES:
        raise _fail(f"only 8-bit PNG is supported (bit depth {depth}, "
                    f"colour type {colour})")
    if interlace:
        raise _fail("interlaced PNG is not supported")
    if not 1 <= width * height <= MAX_PIXELS:
        raise _fail(f"PNG of {width}x{height} pixels")
    if colour == 3 and palette is None:
        raise _fail("palette PNG without PLTE")
    bpp = _SAMPLES[colour]
    row_bytes = width * bpp
    expected = height * (row_bytes + 1)
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat), expected)
    except zlib.error as exc:
        raise _fail(f"corrupt PNG data ({exc})") from None
    if len(raw) != expected:
        raise _fail("truncated PNG data")
    raw = np.frombuffer(raw, np.uint8)
    pixels = host_unfilter()(raw, height, row_bytes, bpp)
    pixels = pixels.reshape(height, width, bpp)
    if colour == 3:
        if int(pixels.max()) >= len(palette):
            raise _fail("palette index out of range")
        pixels = palette[pixels[..., 0]]
    return pixels


def encode_png(img: np.ndarray) -> bytes:
    """(H, W), (H, W, C) uint8 with C in 1-4 -> PNG bytes (filter type 1,
    zlib level 1)."""
    arr = np.ascontiguousarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOUR_TYPE or arr.size == 0:
        raise ImageCodecError(f"Cannot encode an image of shape {img.shape}")
    height, width, channels = arr.shape
    rows = arr.reshape(height, width * channels)
    lines = np.empty((height, width * channels + 1), np.uint8)
    lines[:, 0] = 1
    lines[:, 1:] = rows
    lines[:, 1 + channels:] -= rows[:, :-channels]   # Sub, mod 256

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPE[channels],
                       0, 0, 0)
    return (_PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(lines.tobytes(), 1))
            + chunk(b"IEND", b""))


# -- base64 and data URLs ----------------------------------------------------


def _normalize_rgb(arr: np.ndarray) -> np.ndarray:
    """(H, W, C) u8 -> RGB (app.py:80-83): grey and grey+alpha replicate
    the grey, RGBA drops alpha."""
    if arr.shape[2] in (1, 2):
        return np.repeat(arr[:, :, :1], 3, axis=2)
    if arr.shape[2] == 4:
        return arr[:, :, :3].copy()
    return arr


def _png_chunks_neutral(raw: bytes) -> bool:
    """True iff every chunk of ``raw`` (a valid PNG) is rendering-neutral."""
    return all(kind in _PNG_NEUTRAL_CHUNKS for kind, _ in _chunks(raw))


def _b64_bytes(base64_str: str) -> bytes:
    try:
        if "," in base64_str:
            base64_str = base64_str.split(",", 1)[1]
        raw = base64.b64decode(base64_str)
    except (binascii.Error, ValueError) as exc:
        raise _fail(str(exc)) from None
    if not raw:
        raise _fail("empty payload")
    return raw


def decode_base64_image(base64_str: str) -> np.ndarray:
    """A (possibly data-URL-prefixed) base64 PNG -> (H, W, 3) uint8."""
    return decode_base64_image_ex(base64_str)[0]


def decode_base64_image_ex(base64_str: str) -> tuple[np.ndarray, str | None]:
    """`decode_base64_image` plus the source as a data URL when it may stand
    for the original unchanged: an RGB PNG whose every chunk is
    rendering-neutral (no PLTE, tRNS, gAMA, iCCP, ...), else None."""
    raw = _b64_bytes(base64_str)
    arr = decode_png(raw)
    passthrough = None
    if arr.shape[2] == 3 and _png_chunks_neutral(raw):
        passthrough = _data_url(raw)
    return _normalize_rgb(arr), passthrough


def _data_url(png: bytes) -> str:
    return "data:image/png;base64," + base64.b64encode(png).decode("ascii")


def encode_image_to_base64(img_array: np.ndarray) -> str:
    """An HWC (or HW) uint8 array -> PNG data URL."""
    return _data_url(encode_png(img_array))


def load_image_file(data: bytes) -> tuple[np.ndarray, int, int]:
    """Uploaded PNG bytes -> (array, width, height) (app.py:496-521): grey
    stays one channel, every other colour type becomes RGB."""
    arr = decode_png(data)
    if arr.shape[2] != 1:
        arr = _normalize_rgb(arr)
    return arr, arr.shape[1], arr.shape[0]
