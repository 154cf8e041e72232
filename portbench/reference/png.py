"""A plain PNG writer and reader on the standard library's zlib.

The benchmark encodes its uploads and decodes the server's answers with
these, never with the program's codec, so that the codec under test is
judged by code it does not share.

* `encode`: an 8-bit RGB (or grey, or RGBA) image as libpng and Pillow
  write it by default: each row's filter (None, Sub, Up, Average or Paeth)
  chosen by the least sum of absolute signed residuals, the PNG
  specification's heuristic, then zlib level 6.  The row filter is a frozen
  copy of `chip_smoke.py::client_png` and `filter_predictions`.
* `decode`: any non-interlaced 8-bit grey, RGB or RGBA PNG, every chunk's
  CRC checked.  None, Sub and Up rows are undone with numpy over whole
  rows; Average and Paeth rows, whose bytes depend on the byte to their
  left, one byte at a time (slow, and written by none of today's encoders
  on the answer path).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples a pixel


class PNGError(ValueError):
    """Bytes this reader does not take as a PNG it reads."""


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def filter_predictions(x: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, row bytes) int16: the predictions of the five filters for
    packed rows `x` (int16), `bpp` bytes a filter unit."""
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    return np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an (H, W, C) uint8 image, C in 1, 3, 4."""
    h, w, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}[c]
    x = np.ascontiguousarray(img, np.uint8).reshape(h, w * c).astype(np.int16)
    lines = np.empty((h, w * c + 1), np.uint8)
    best = None
    for kind, pred in enumerate(filter_predictions(x, c)):
        res = ((x - pred) & 0xFF).astype(np.uint8)
        cost = np.abs(res.view(np.int8).astype(np.int32)).sum(axis=1)
        take = np.ones(h, bool) if best is None else cost < best
        best = cost if best is None else np.where(take, cost, best)
        lines[take, 0] = kind
        lines[take, 1:] = res[take]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), level))
            + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    if not data.startswith(SIGNATURE):
        raise PNGError("no PNG signature")
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise PNGError(f"chunk {kind!r} at byte {pos} is cut or its CRC "
                           "is wrong")
        yield kind, payload
        pos += 12 + length
        if kind == b"IEND":
            return
    raise PNGError("no IEND chunk")


def _unfilter_slow(kind: int, line: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) or Paeth (4) undone in place, byte by byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def decode(data: bytes) -> np.ndarray:
    """The (H, W, C) uint8 pixels of PNG `data`."""
    ihdr, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if ihdr is None or not idat:
        raise PNGError("no IHDR or no IDAT")
    w, h, depth, colour, _, _, interlace = ihdr
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise PNGError(f"depth {depth}, colour type {colour}, interlace "
                       f"{interlace}: this reader takes 8-bit grey, RGB and "
                       "RGBA without interlace")
    c = _CHANNELS[colour]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise PNGError(f"{raw.size} bytes of scanlines for {h} rows of "
                       f"{stride + 1}")
    rows = raw.reshape(h, stride + 1)
    kinds, out = rows[:, 0], rows[:, 1:].copy()
    if kinds.max(initial=0) > 4:
        raise PNGError(f"filter type {int(kinds.max())}")
    # Sub: each byte adds the reconstructed byte bpp to its left, a running
    # sum modulo 256 over each byte's position within its pixel.
    sub = kinds == 1
    for j in range(c):
        out[sub, j::c] = np.cumsum(out[sub, j::c], axis=1, dtype=np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = kinds[y]
        if kind == 2:
            out[y] += prior
        elif kind in (3, 4):
            line = bytearray(out[y].tobytes())
            _unfilter_slow(int(kind), line, prior.tobytes(), c)
            out[y] = np.frombuffer(bytes(line), np.uint8)
        prior = out[y]
    return out.reshape(h, w, c)
