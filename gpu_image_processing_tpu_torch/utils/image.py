"""Image codec: base64 and data URLs <-> numpy HWC uint8, for every upload
format the JAX package serves.

Same contract as the JAX package's helpers (gpu_image_processing_tpu/utils/
image.py, after backend/app.py:66-111): inbound images are normalized so
the serving path always processes RGB (grey, grey+alpha, palette and RGBA
are converted); outbound images are PNG-encoded and returned as a
``data:image/png;base64,`` URL.

Uploads are routed as the JAX package routes them without Pillow (its
tier on a host without Pillow, such as the card's machine):

* first the native PNG tier, `native_codec.png_decode` (tier
  ``native_png``), `gip_png_decode` of native/src/gip_codec.cpp as the JAX
  package tries it first: every bit depth, colour type and Adam7, reduced
  as stb_image reduces them (16-bit samples keep their high byte);
* a PNG the native tier refuses: the zlib tier below (tier ``zlib_png``),
  which stands in for the JAX package's Pillow tier.  It reduces to 8 bits
  as Pillow does there (16-bit grey rescales by its maximum, `_pil_to_rgb`)
  and checks the chunks' CRCs, IEND, the header and the pixel cap
  `MAX_PIXELS`;
* JPEG (baseline and progressive), then by magic bytes HDR and PIC, then GIF, BMP, PSD and
  binary PNM, and last TGA, which has no magic bytes (`_tga_plausible`):
  the C++ decoders of `native/src` through utils/native_codec.py (tiers
  ``native_jpeg`` ... ``native_tga``), built at first use.

`load_image_file` (the upload endpoint and the image-file CLI),
`decode_png16` and `decode_file_16` read PNG through the zlib tier too, as
the JAX package's file loaders open PNG with Pillow.  The tier runs its own
checks, then takes the samples from `native_codec.png_decode16`
(`gip_png_decode16`) for `decode_png16` and for 16-bit grey, which it
rescales by its maximum, and from `native_codec.png_decode`
(`gip_png_decode`, the same decoder's high bytes) for every other 8-bit
result, wherever they accept the file.  They accept and refuse the same
files.  Only a file the checks accept and gip refuses is inflated here
with Python's `zlib` and unfiltered by `unfilter_plain`, in numpy and
Python, row by row (`_png_samples`): a palette of more than 256 entries,
a tRNS chunk longer than the palette or before it, image data that
inflates past the size its header declares or whose stream does not end.  Every PNG answer is
`native_codec.png_encode(img, 1)`: `gip_png_encode`, the Sub filter and
zlib level 1 with run-length matching.

A base64 upload's decode is the spans `codec.b64decode` and `codec.decode`
(whichever tier serves it), an answer's encode `codec.encode` and
`codec.b64encode` (core/spans.py); the passthrough original's base64 is a
`codec.b64encode` too.
"""

from __future__ import annotations

import base64
import binascii
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..core import spans
from . import native_codec


class ImageCodecError(ValueError):
    pass


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: Decode-bomb guard of the zlib tier: the largest image a PNG may declare.
MAX_PIXELS = 1 << 28
#: Samples a pixel of each PNG colour type, and the depths it allows (PNG
#: specification, table 11.1).
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
#: Adam7 passes: (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

# PNG chunk types that cannot change how decoded pixels render; an RGB PNG
# made only of these may pass through as the original image unchanged.
_PNG_NEUTRAL_CHUNKS = frozenset(
    [b"IHDR", b"IDAT", b"IEND", b"tEXt", b"zTXt", b"iTXt", b"tIME", b"pHYs"]
)

# JPEG marker segments that cannot change how decoded pixels render:
# APP0/JFIF carries only density and thumbnail; DQT/DHT/DRI/COM/SOF0 are
# encoding structure.  Anything else (APP1 EXIF orientation, APP2 ICC,
# APP14 Adobe transforms, progressive or arithmetic SOFs, other APPn) may
# make a browser show the source bytes otherwise than the decoded pixels.
_JPEG_NEUTRAL_MARKERS = frozenset([0xE0, 0xDB, 0xC4, 0xC0, 0xDD, 0xFE])


def _fail(why: str) -> ImageCodecError:
    return ImageCodecError(f"Failed to decode image: {why}")


# -- decode tiers --------------------------------------------------------------

# Which decoder served each base64 upload, in /api/stats as `decode_tiers`:
# the JAX package's native keys and `failed`, and `zlib_png` for the PNGs
# the native tier refuses and the codec here decodes.
DECODE_TIERS = (
    "zlib_png",
    "native_png",
    "native_jpeg",
    "native_gif",
    "native_bmp",
    "native_psd",
    "native_hdr",
    "native_pic",
    "native_pnm",
    "native_tga",
    "failed",
)
_tier_lock = threading.Lock()
_tier_counts = dict.fromkeys(DECODE_TIERS, 0)


def _count_decode(tier: str) -> None:
    with _tier_lock:
        _tier_counts[tier] += 1


def decode_tier_counts() -> dict[str, int]:
    """Per-tier decode counts since the process started."""
    with _tier_lock:
        return dict(_tier_counts)


# -- unfiltering -------------------------------------------------------------


def unfilter_plain(raw: np.ndarray, height: int, row_bytes: int,
                   bpp: int) -> np.ndarray:
    """(height, row_bytes) uint8 from the inflated scanlines `raw`
    (height * (1 + row_bytes) bytes), for the files gip's decoders
    refuse.  None, Sub and Up run in numpy; Average and Paeth byte by
    byte, which takes seconds on a photograph."""
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


# -- PNG ---------------------------------------------------------------------


@dataclass(frozen=True)
class PngHeader:
    width: int
    height: int
    depth: int
    colour: int
    interlace: int


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, through IEND."""
    pos = len(PNG_SIGNATURE)
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


@dataclass(frozen=True)
class _PngChunks:
    """What the zlib tier reads of a PNG's chunks."""
    header: PngHeader
    palette: Optional[np.ndarray]   # (N, 3) uint8, for colour type 3
    trns: Optional[bytes]
    idat: list


def _png_chunks(data: bytes) -> _PngChunks:
    """The zlib tier's checks of a PNG, before any pixel is read: the
    signature, every chunk's CRC through IEND, the header (depth, colour
    type, interlace method, at most `MAX_PIXELS` pixels), PLTE for a
    palette."""
    if not data.startswith(PNG_SIGNATURE):
        raise _fail("not a PNG")
    header = palette = trns = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise _fail("bad PNG IHDR")
            width, height, depth, colour, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            header = PngHeader(width, height, depth, colour, interlace)
        elif kind == b"PLTE":
            if len(payload) % 3 or not payload:
                raise _fail("bad PNG palette")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise _fail("PNG without IHDR")
    if header.depth not in DEPTHS.get(header.colour, ()):
        raise _fail(f"PNG of bit depth {header.depth} and colour type "
                    f"{header.colour}")
    if header.interlace not in (0, 1):
        raise _fail(f"PNG interlace method {header.interlace}")
    if not 1 <= header.width * header.height <= MAX_PIXELS:
        raise _fail(f"PNG of {header.width}x{header.height} pixels")
    if header.colour == 3 and palette is None:
        raise _fail("palette PNG without PLTE")
    return _PngChunks(header, palette, trns, idat)


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


def _png_samples(png: _PngChunks) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """(samples, palette) of a PNG that gip's decoders refuse, inflated
    with Python's zlib and unfiltered by `unfilter_plain`: (H, W, S) values
    at the image's own depth (uint16 at 16 bits, uint8 below; palette
    indices for colour type 3), Adam7 passes put in place; for colour type
    3, the (N, 3) uint8 palette, or (N, 4) with the alpha of a tRNS chunk
    (255 past its entries)."""
    header, palette = png.header, png.palette
    width, height, depth = header.width, header.height, header.depth
    samples = SAMPLES[header.colour]
    bpp = max(1, samples * depth // 8)
    passes = ADAM7 if header.interlace else ((0, 0, 1, 1),)
    geometry = []   # (x0, y0, dx, dy, pass width, pass height, row bytes)
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            geometry.append((x0, y0, dx, dy, pw, ph,
                             -(-pw * samples * depth // 8)))
    expected = sum(ph * (1 + rb) for *_, ph, rb in geometry)
    inflater = zlib.decompressobj()
    try:
        raw = np.frombuffer(inflater.decompress(b"".join(png.idat), expected),
                            np.uint8)
    except zlib.error as exc:
        raise _fail(f"corrupt PNG data ({exc})") from None
    if raw.size != expected:
        raise _fail("truncated PNG data")
    out = np.empty((height, width, samples),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, row_bytes in geometry:
        size = ph * (1 + row_bytes)
        packed = unfilter_plain(raw[pos:pos + size], ph, row_bytes, bpp)
        out[y0::dy, x0::dx] = png_unpack(packed, pw, samples, depth)
        pos += size
    if header.colour == 3:
        if int(out.max()) >= len(palette):
            raise _fail("palette index out of range")
        if png.trns is not None:
            alpha = np.full((len(palette), 1), 255, np.uint8)
            alpha[:len(png.trns), 0] = np.frombuffer(
                png.trns[:len(palette)], np.uint8)
            palette = np.hstack([palette, alpha])
    return out, palette


def _png_plain16(png: _PngChunks) -> np.ndarray:
    """`decode_png16` through the plain path: `_png_samples`, widened as
    gip_png_decode16 widens them."""
    values, palette = _png_samples(png)
    header = png.header
    if header.colour == 3:
        values = palette[values[..., 0]]
    elif header.depth == 16:
        return values
    elif header.depth < 8:
        values = values * np.uint8(255 // ((1 << header.depth) - 1))
    return values.astype(np.uint16) * np.uint16(257)


def _png16(png: _PngChunks, data: bytes) -> np.ndarray:
    """`decode_png16` of a PNG that passed the tier's checks: the samples of
    `native_codec.png_decode16` where it accepts the file, else of the plain
    path."""
    values = native_codec.png_decode16(data)
    return values if values is not None else _png_plain16(png)


def _decode_png(data: bytes) -> tuple[np.ndarray, PngHeader]:
    """`decode_png` and the PNG's header: the tier's checks, then 16-bit
    grey from `_png16`, every other image from `native_codec.png_decode`
    (the high byte of each sample gip_png_decode16 reads, without its
    16-bit image) or, where that refuses the file, the plain path."""
    png = _png_chunks(data)
    header = png.header
    if header.depth == 16 and header.colour == 0:
        # The JAX package's Pillow tier opens 16-bit grey as mode I;16 and
        # rescales it by its maximum in float32, then truncates
        # (_pil_to_rgb).
        values = _png16(png, data)
        scale = np.float32(255.0 / max(float(values.max()), 1.0))
        return (values.astype(np.float32) * scale).astype(np.uint8), header
    values = native_codec.png_decode(data)
    if values is None:
        # 16-bit samples keep their high byte; lower depths were widened as
        # v * 257, whose high byte is v.
        values = (_png_plain16(png) >> 8).astype(np.uint8)
    if header.colour == 3:
        values = np.ascontiguousarray(values[..., :3])
    return values, header


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8: C = 1 (grey), 2 (grey+alpha), 3 (RGB,
    and palette expanded through PLTE) or 4 (RGBA).  Depths other than 8
    are reduced as the module docstring says.  A tRNS chunk is ignored:
    alpha goes when the caller normalizes to RGB."""
    return _decode_png(data)[0]


def decode_png16(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint16, as the JAX package's native tier reads
    them (`png_decode16`, the stbi_load_16 analog): 16-bit samples as
    stored; lower depths after the grey range expansion or the palette
    lookup, as v * 257; a palette with a tRNS chunk gives RGBA.  The zlib
    tier's checks first, as the module docstring says."""
    return _png16(_png_chunks(data), data)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W), (H, W, C) uint8 with C in 1-4 -> PNG bytes: the native
    tier's `png_encode(img, 1)` (Sub filter, zlib level 1 with run-length
    matching)."""
    png = native_codec.png_encode(img, 1)
    if png is None:
        raise ImageCodecError(f"Cannot encode an image of shape {img.shape}")
    return png


# -- the native decoders, by magic bytes --------------------------------------

Decoder = Callable[[bytes], Optional[np.ndarray]]


def _sniff_native_first(raw: bytes) -> tuple[Optional[Decoder], Optional[str]]:
    """HDR and PIC, which only the native tier reads."""
    if raw[:2] == b"#?":
        return native_codec.hdr_decode, "native_hdr"
    if raw[:4] == b"\x53\x80\xf6\x34":
        return native_codec.pic_decode, "native_pic"
    return None, None


def _sniff_native_fallback(raw: bytes) -> tuple[Optional[Decoder], Optional[str]]:
    """GIF, BMP, PSD, binary PNM, and last TGA, which has no magic bytes."""
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return native_codec.gif_decode, "native_gif"
    if raw[:2] == b"BM":
        return native_codec.bmp_decode, "native_bmp"
    if raw[:4] == b"8BPS":
        return native_codec.psd_decode, "native_psd"
    if raw[:2] in (b"P5", b"P6") and len(raw) > 2 and raw[2:3].isspace():
        return native_codec.pnm_decode, "native_pnm"
    if _tga_plausible(raw):
        return native_codec.tga_decode, "native_tga"
    return None, None


def _tga_plausible(raw: bytes) -> bool:
    """Header plausibility sniff for TGA, which has no magic bytes.

    Tried last (stb_image tries TGA last for the same reason); the decoder
    validates everything again, this only keeps arbitrary bytes from
    reaching it.
    """
    if len(raw) < 18:
        return False
    cmap_type, img_type, bpp = raw[1], raw[2], raw[16]
    if cmap_type not in (0, 1) or img_type not in (1, 2, 3, 9, 10, 11):
        return False
    if bpp not in (8, 15, 16, 24, 32):
        return False
    w = raw[12] | (raw[13] << 8)
    h = raw[14] | (raw[15] << 8)
    return w > 0 and h > 0


def _decode_raw(raw: bytes) -> tuple[np.ndarray, str, Optional[PngHeader]]:
    """(H, W, C) uint8, its tier, and the PNG header for a PNG."""
    if raw.startswith(PNG_SIGNATURE):
        arr, header = _decode_png(raw)
        return arr, "zlib_png", header
    if len(raw) > 3 and raw[:2] == b"\xff\xd8":
        fn, tier = native_codec.jpeg_decode, "native_jpeg"
    else:
        fn, tier = _sniff_native_first(raw)
        if fn is None:
            fn, tier = _sniff_native_fallback(raw)
    if fn is None:
        raise _fail("unrecognised image format (PNG, JPEG, GIF, BMP, PSD, "
                    "HDR, PIC, PNM and TGA are read)")
    arr = fn(raw)
    if arr is None:
        raise _fail(f"not a decodable {tier.split('_', 1)[1].upper()} image "
                    f"(malformed, truncated, or a variant the decoder does "
                    f"not read)")
    return arr, tier, None


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
    """True iff every chunk of ``raw`` (a PNG) is rendering-neutral and its
    CRC holds."""
    try:
        return all(kind in _PNG_NEUTRAL_CHUNKS for kind, _ in _chunks(raw))
    except ImageCodecError:
        return False


def _leading_ihdr(raw: bytes) -> Optional[PngHeader]:
    """The header of a PNG whose first chunk is IHDR, else None."""
    if raw[12:16] != b"IHDR":
        return None
    width, height, depth, colour = struct.unpack_from(">IIBB", raw, 16)
    return PngHeader(width, height, depth, colour, raw[28])


def _jpeg_headers_neutral(raw: bytes) -> bool:
    """True iff ``raw`` is a single-scan baseline JPEG whose every header
    segment is rendering-neutral.

    Headers up to the first SOS must be from the neutral set; the tail
    after SOS must be entropy data (0xFF00 stuffing and RST markers) ending
    in exactly one EOI with nothing after it.  A baseline file may carry
    several scans with segments between them, so the tail is checked, not
    assumed: any marker in it other than RST or EOI (a second scan's DHT or
    SOS, a late APP1, ...) rejects the passthrough.
    """
    n = len(raw)
    if n < 4 or raw[0] != 0xFF or raw[1] != 0xD8:
        return False
    pos = 2
    saw_sof0 = False
    while pos + 4 <= n:
        if raw[pos] != 0xFF:
            return False
        marker = raw[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xDA:  # SOS: check the entropy tail
            if not saw_sof0:
                return False
            seg_len = int.from_bytes(raw[pos + 2:pos + 4], "big")
            if seg_len < 2:
                return False
            pos += 2 + seg_len
            # Marker to marker with bytes.find: stuffed 0xFF bytes are
            # about 1/256 of the entropy data.
            while True:
                pos = raw.find(b"\xff", pos)
                if pos < 0 or pos + 1 >= n:
                    return False  # no EOI
                m = raw[pos + 1]
                if m == 0x00 or 0xD0 <= m <= 0xD7:  # stuffing / RSTn
                    pos += 2
                    continue
                if m == 0xD9:  # EOI: must be the final bytes
                    return pos + 2 == n
                return False  # a second scan or late metadata
        if marker not in _JPEG_NEUTRAL_MARKERS:
            return False
        if marker == 0xC0:
            saw_sof0 = True
        seg_len = int.from_bytes(raw[pos + 2:pos + 4], "big")
        if seg_len < 2:
            return False
        pos += 2 + seg_len
    return False  # truncated before SOS


def _b64_bytes(base64_str: str) -> bytes:
    try:
        if "," in base64_str:
            base64_str = base64_str.split(",", 1)[1]
        with spans.span("codec.b64decode"):
            raw = base64.b64decode(base64_str)
    except (binascii.Error, ValueError) as exc:
        raise _fail(str(exc)) from None
    if not raw:
        raise _fail("empty payload")
    return raw


def decode_base64_image(base64_str: str) -> np.ndarray:
    """A (possibly data-URL-prefixed) base64 image -> (H, W, 3) uint8."""
    return decode_base64_image_ex(base64_str)[0]


def decode_base64_image_ex(base64_str: str) -> tuple[np.ndarray, str | None]:
    """`decode_base64_image` plus the source as a data URL when it may stand
    for the original unchanged: an 8-bit RGB PNG whose every chunk is
    rendering-neutral (no PLTE, tRNS, gAMA, iCCP, ...), or a baseline RGB
    JPEG whose every header segment is (no EXIF orientation, ICC profile,
    Adobe transform, ...; the browser decodes those bytes, which may differ
    from this decode by the IDCT's rounding), else None."""
    try:
        raw = _b64_bytes(base64_str)
        with spans.span("codec.decode"):
            arr = native_codec.png_decode(raw)
            if arr is not None:
                tier, png = "native_png", _leading_ihdr(raw)
            else:
                arr, tier, png = _decode_raw(raw)
    except ImageCodecError:
        _count_decode("failed")
        raise
    _count_decode(tier)
    passthrough = None
    if png is not None:
        if png.colour == 2 and png.depth == 8 and _png_chunks_neutral(raw):
            passthrough = _data_url("image/png", raw)
    elif tier == "native_jpeg" and arr.shape[2] == 3 and _jpeg_headers_neutral(raw):
        passthrough = _data_url("image/jpeg", raw)
    return _normalize_rgb(arr), passthrough


def _data_url(mime: str, payload: bytes) -> str:
    with spans.span("codec.b64encode"):
        return f"data:{mime};base64," + base64.b64encode(payload).decode("ascii")


def encode_image_to_base64(img_array: np.ndarray) -> str:
    """An HWC (or HW) uint8 array -> PNG data URL."""
    with spans.span("codec.encode"):
        png = encode_png(img_array)
    return _data_url("image/png", png)


def load_image_file(data: bytes) -> tuple[np.ndarray, int, int]:
    """Uploaded file bytes -> (array, width, height) (app.py:496-521).

    Grey stays one channel where the JAX package's Pillow tier keeps mode
    L (8-bit grey JPEG, PNM, PSD and TGA; 2-, 4- and 8-bit grey PNG); every
    other image becomes RGB, 1- and 16-bit grey PNG included (Pillow's
    modes 1 and I;16).
    """
    arr, _, png = _decode_raw(data)
    keep_grey = arr.shape[2] == 1 and (png is None or png.depth in (2, 4, 8))
    if not keep_grey:
        arr = _normalize_rgb(arr)
    return arr, arr.shape[1], arr.shape[0]


def decode_file_16(data: bytes) -> np.ndarray:
    """Any upload -> HWC uint16, the stbi_load_16_from_memory analog of the
    JAX package: PNG (`native_codec.png_decode16` first, as the JAX package
    reads it, then the zlib tier's `decode_png16`) and PSD at their own 16
    bits where the file carries them; every other format, and every 8-bit file, as
    `load_image_file`'s pixels v -> v * 257 (stb's stbi__convert_8_to_16)."""
    if data.startswith(PNG_SIGNATURE):
        arr = native_codec.png_decode16(data)
        return arr if arr is not None else decode_png16(data)
    if data[:4] == b"8BPS":
        arr = native_codec.psd_decode16(data)
        if arr is not None:
            return arr
    arr8, _, _ = load_image_file(data)
    return arr8.astype(np.uint16) * np.uint16(257)


def decode_file_float(data: bytes) -> np.ndarray:
    """Any upload -> HWC float32, the stbi_loadf_from_memory analog of the
    JAX package: Radiance HDR as linear floats (m * 2^(e - 136), no tone
    map); other formats through stb's LDR-to-HDR default, (v / 255)^2.2."""
    if data[:2] == b"#?":
        arr = native_codec.hdr_decodef(data)
        if arr is not None:
            return arr
    arr8, _, _ = load_image_file(data)
    return (arr8.astype(np.float32) / np.float32(255.0)) ** np.float32(2.2)
