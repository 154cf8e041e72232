"""A plain baseline JPEG writer, and the decode that the written file
stands for.

The benchmark writes its JPEG uploads with `encode`, never with the
program's codec, and judges the server's decode of them by `decode`, which
works from the coefficients the writer wrote, so that the decoder under
test is judged by code it does not share.  Plain numpy throughout; nothing
here imports the program, JAX or Pillow.

The writer, `encode`: baseline sequential DCT (SOF0), 8-bit YCbCr, one
interleaved scan, as a phone camera or libjpeg writes one:

* RGB to YCbCr and 4:2:0's 2x2 chroma means as libjpeg makes them
  (`jccolor.c`, `jcsample.c`: T.871 in 16-bit fixed point, rounded);
  chroma at 4:4:4 or at 4:2:0 (h2v2);
* the right and bottom edges replicated out to whole MCUs, so any size
  works (T.81 A.2.4: the decoder drops what lies past the image);
* the exact FDCT (T.81 A.3.3, the orthonormal 8x8 DCT-II) in float64,
  each coefficient divided by its table entry and rounded to nearest;
* the Annex K quantisation tables (K.1, K.2) scaled by the IJG quality
  formula (libjpeg's `jpeg_quality_scaling`), and the Annex K Huffman
  tables (K.3-K.6);
* optionally an APP1 Exif segment whose one tag is Orientation = 1, as a
  phone camera writes (which makes a server that passes rendering-neutral
  JPEGs through decode this one); without it, an APP0 JFIF segment;
* the FDCT, the run-length step, the bit packing and the 0xFF stuffing
  vectorised with numpy, in bands of MCU rows on threads that make one
  stream: a 4032x3024 image takes about a second on 8 cores.

It returns the file's bytes with the quantised coefficients it wrote.

The reference decode, `decode`, from those coefficients (no entropy
decoding: the writer holds what it coded):

* each coefficient times its table entry, then the exact IDCT (T.81
  A.3.3) in float64, level-shifted by 128, rounded half up and clamped to
  0..255, plane by plane;
* 4:2:0 chroma upsampled by libjpeg's default h2v2 "fancy" triangular
  filter (`jdsample.c::h2v2_fancy_upsample`): vertically 3:1 with the
  nearer chroma row, then horizontally 3:1 with the nearer column, +8 on
  even and +7 on odd outputs, >> 4, the edge rows and columns replicated.
  That is what libjpeg and libjpeg-turbo give by default, and so what
  Pillow gives upstream's server;
* YCbCr to RGB by T.871 in float64, rounded half up and clamped.

A conforming decoder may round otherwise at each of the three steps (an
integer IDCT within IEEE 1180's accuracy, its own upsampler's biases, a
fixed-point colour conversion), so a decode is held to this one within a
stated tolerance, not to the bit.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

#: The natural (row-major) index of each zigzag position (T.81 figure A.6).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

#: Annex K tables K.1 (luminance) and K.2 (chrominance), natural order.
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *[99] * 32])

#: Annex K Huffman tables K.3-K.6: (code counts by length 1..16, symbols).
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

SUBSAMPLING = {"4:4:4": 1, "4:2:0": 2}   # luma samples per chroma sample
#: Bands of MCU rows written at once; the bytes do not depend on it.
THREADS = 8


class JPEGError(ValueError):
    """Arguments this writer does not take."""


@dataclass
class Written:
    """A written JPEG: its bytes, and per component (Y, Cb, Cr) the
    quantised coefficients, (block rows, block columns, 64) int16, and the
    (64,) table they were divided by, both in zigzag order as the file
    holds them."""

    data: bytes
    height: int
    width: int
    subsampling: str
    coefficients: list[np.ndarray]
    tables: list[np.ndarray]


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """An Annex K table scaled to `quality` (1..100) by the IJG formula,
    each entry clamped to 1..255 (baseline), natural order."""
    if not 1 <= quality <= 100:
        raise JPEGError(f"quality {quality} is outside 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_matrix() -> np.ndarray:
    """C[u, x] = c(u) cos((2x + 1) u pi / 16), c(0) = sqrt(1/8), else 1/2:
    the FDCT is C B C^T and the IDCT C^T F C (T.81 A.3.3)."""
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    c = np.where(u == 0, np.sqrt(1 / 8), 0.5)
    return c * np.cos((2 * x + 1) * u * np.pi / 16)


DCT = _dct_matrix()
#: The 2-D transform of a row-major block: F = B @ _DCT2.T, B = F @ _DCT2.
_DCT2 = np.kron(DCT, DCT)


def _huffman(spec) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of each of the 256 symbols (T.81 Annex C)."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)


#: libjpeg's `jccolor.c`: T.871's coefficients in 16-bit fixed point, rows
#: Y, Cb, Cr; the chroma rows' offset 128 and the rounding.
_YCC = np.array([[19595, 38470, 7471],
                 [-11059, -21709, 32768],
                 [32768, -27439, -5329]], np.int32)
_YCC_ADD = np.array([32768, (128 << 16) + 32767, (128 << 16) + 32767])


def rgb_to_ycc(img: np.ndarray) -> list[np.ndarray]:
    """(H, W, 3) uint8 RGB -> Y, Cb, Cr (H, W) int32 samples, as libjpeg
    converts them (T.871 in 16-bit fixed point, rounded)."""
    rgb = [img[..., i].astype(np.int32) for i in range(3)]
    return [(m[0] * rgb[0] + m[1] * rgb[1] + m[2] * rgb[2] + add) >> 16
            for m, add in zip(_YCC, _YCC_ADD)]


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Full-size uint8 planes -> (H, W, 3) uint8 RGB (T.871, float64,
    rounded half up, clamped)."""
    y = y.astype(np.float64)
    cb = cb.astype(np.float64) - 128
    cr = cr.astype(np.float64) - 128
    r = y + 1.402 * cr
    b = y + 1.772 * cb
    g = y - (0.114 * 1.772 / 0.587) * cb - (0.299 * 1.402 / 0.587) * cr
    return np.stack([_round_u8(r), _round_u8(g), _round_u8(b)], -1)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8h, 8w) -> (h, w, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    by, bx = blocks.shape[:2]
    return blocks.swapaxes(1, 2).reshape(by * 8, bx * 8)


def _scan(coefs: list[np.ndarray], f: int) -> np.ndarray:
    """The blocks in interleaved scan order, each MCU's f x f luma blocks
    row by row, then its Cb and Cr block: (N, 64) int16."""
    y, cb, cr = coefs
    my, mx = cb.shape[:2]
    luma = y.reshape(my, f, mx, f, 64).swapaxes(1, 2).reshape(my, mx, f * f, 64)
    return np.concatenate([luma, cb[:, :, None], cr[:, :, None]],
                          axis=2).reshape(-1, 64)


#: Size category of each magnitude 0..2047 (T.81 F.1.2.1).
_SIZE = np.concatenate([[0], np.floor(np.log2(np.arange(1, 2048))) + 1]
                       ).astype(np.int64)


def _magnitude(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each value's size category and its extra bits: the value, or for a
    negative one the value less one, in that many bits."""
    v = v.astype(np.int64)
    size = _SIZE[np.abs(v)]
    return size, (v - (v < 0)) & ((1 << size) - 1)


def _codes(specs) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of luma symbol s at s and of chroma symbol s at
    256 + s."""
    pairs = [_huffman(s) for s in specs]
    return (np.concatenate([c for c, _ in pairs]),
            np.concatenate([n for _, n in pairs]))


_DC_CODES = _codes((DC_LUMA, DC_CHROMA))
_AC_CODES = _codes((AC_LUMA, AC_CHROMA))


def _dc_diffs(dc: np.ndarray, f: int) -> np.ndarray:
    """Each block's DC less the last DC of the same component before it
    in scan order (the first of each component less 0)."""
    dc = dc.astype(np.int64).reshape(-1, f * f + 2)
    diff = np.empty_like(dc)
    diff[:, :f * f] = np.diff(dc[:, :f * f].ravel(), prepend=0
                              ).reshape(-1, f * f)
    for c in (f * f, f * f + 1):
        diff[:, c] = np.diff(dc[:, c], prepend=0)
    return diff.ravel()


def _tokens(scan: np.ndarray, diff: np.ndarray, f: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """The Huffman codes, with their extra bits, of blocks `scan` (N, 64)
    of whole MCUs (f * f luma blocks, a Cb and a Cr block) whose DC
    differences are `diff`: (value, bit length) a code, in stream order.

    A block's codes are its DC, then per nonzero AC coefficient the ZRLs
    (16 zeros each) before it and itself, then an EOB unless its last
    coefficient is nonzero; each code's place is counted from the codes
    before it."""
    n, per_mcu = len(scan), f * f + 2
    chroma = np.tile(np.arange(per_mcu) >= f * f, n // per_mcu) * 256
    # AC: flat index 63 b + k - 1 of coefficient k of block b.
    nonzero = scan[:, 1:] != 0
    flat = np.flatnonzero(nonzero)
    b = flat // 63
    floor = b * 63 - 1                 # where a block's run starts counting
    run = flat - np.maximum(np.concatenate([[-1], flat[:-1]]), floor) - 1
    zrl = run >> 4
    zrl_before = np.cumsum(zrl)        # ZRLs up to and with each token's
    some_zrl = bool(zrl_before[-1:].any())
    eob = scan[:, 63] == 0
    per_block = np.bincount(b, minlength=n)
    if some_zrl:
        per_block += np.bincount(b, zrl, minlength=n).astype(np.int64)
    count = 1 + per_block + eob
    start = np.cumsum(count) - count
    val = np.zeros(int(count.sum()), np.int64)
    length = np.zeros(len(val), np.int64)

    def put(pos, codes, index, size, bits):
        val[pos] = (codes[0][index] << size) | bits
        length[pos] = codes[1][index] + size

    size, bits = _magnitude(diff)
    put(start, _DC_CODES, chroma + size, size, bits)
    size, bits = _magnitude(scan[:, 1:][nonzero])
    # Before an AC code: the DCs of its block and those before, the EOBs
    # before its block, the AC codes before it and the ZRLs.
    eob_before = np.cumsum(eob) - eob
    pos = (np.arange(1, n + 1) + eob_before)[b] + np.arange(len(b)) + zrl_before
    put(pos, _AC_CODES, chroma[b] + ((run & 15) << 4) + size, size, bits)
    if some_zrl:
        z = np.repeat(np.arange(len(b)), zrl)
        nth = np.arange(len(z)) - np.repeat(zrl_before - zrl, zrl)
        put(pos[z] - zrl[z] + nth, _AC_CODES, chroma[b[z]] + 0xF0, 0, 0)
    ends = np.flatnonzero(eob)
    put(start[ends] + count[ends] - 1, _AC_CODES, chroma[ends], 0, 0)
    return val, length


def _pack(val: np.ndarray, length: np.ndarray, lead: int) -> np.ndarray:
    """Codes `val` of bit lengths `length`, MSB first, in 32-bit words
    (uint64 each), the first code `lead` bits into the first word.

    Each code (at most 27 bits) lies in the 64-bit window of the word it
    starts in and the next.  No code covers a whole word, so every word
    holds the start of one, and a word is the OR of the high halves of the
    codes that start in it and the low halves of those that start in the
    word before."""
    off = np.cumsum(length) - length + lead
    window = val.view(np.uint64) << (64 - (off & 31) - length).astype(np.uint64)
    starts = np.flatnonzero(np.diff(off >> 5, prepend=-1))
    high = np.bitwise_or.reduceat(window >> np.uint64(32), starts)
    low = np.bitwise_or.reduceat(window & np.uint64(0xFFFFFFFF), starts)
    high[1:] |= low[:-1]
    return np.append(high, low[-1])


def _stuff(data: np.ndarray) -> bytes:
    """A 0x00 after every 0xFF of the entropy-coded data (T.81 F.1.2.3)."""
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


EXIF = (b"Exif\x00\x00" + b"MM\x00\x2a" + struct.pack(">I", 8)
        + struct.pack(">HHHIHH", 1, 0x0112, 3, 1, 1, 0) + struct.pack(">I", 0))
JFIF = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _headers(height: int, width: int, f: int, tables, exif: bool) -> bytes:
    out = [b"\xff\xd8", _segment(0xE1, EXIF) if exif
           else _segment(0xE0, JFIF)]
    out.append(_segment(0xDB, b"".join(
        bytes([i]) + t.astype(np.uint8).tobytes()
        for i, t in enumerate(tables[:2]))))
    out.append(_segment(0xC0, struct.pack(
        ">BHHB", 8, height, width, 3) + bytes(
        [1, f * 16 + f, 0, 2, 0x11, 1, 3, 0x11, 1])))
    dht = b""
    for cls_id, (counts, symbols) in ((0x00, DC_LUMA), (0x10, AC_LUMA),
                                      (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
        dht += bytes([cls_id, *counts]) + bytes(symbols)
    out.append(_segment(0xC4, dht))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


def encode(img: np.ndarray, quality: int = 90, subsampling: str = "4:2:0",
           exif: bool = True) -> Written:
    """A baseline JPEG of the (H, W, 3) uint8 RGB image `img`."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise JPEGError(f"an image {img.shape} {img.dtype}: the writer takes "
                        "(H, W, 3) uint8")
    if subsampling not in SUBSAMPLING:
        raise JPEGError(f"subsampling {subsampling!r}: one of "
                        f"{sorted(SUBSAMPLING)}")
    h, w, _ = img.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise JPEGError(f"size {h}x{w} is outside a JPEG's 1..65535")
    f = SUBSAMPLING[subsampling]
    mcu = 8 * f
    mh, mw = -(-h // mcu) * mcu, -(-w // mcu) * mcu
    padded = np.pad(img, ((0, mh - h), (0, mw - w), (0, 0)), mode="edge")
    luma, chroma = quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)
    tables = [luma[ZIGZAG], chroma[ZIGZAG], chroma[ZIGZAG]]
    # Bands of whole MCU rows, each on a thread (numpy lets go of the
    # interpreter's lock in its loops); the stream is one, as without them.
    rows = np.array_split(np.arange(mh // mcu), min(THREADS, mh // mcu))
    with ThreadPoolExecutor(len(rows)) as pool:
        parts = list(pool.map(
            lambda r: _transform(padded[r[0] * mcu:(r[-1] + 1) * mcu], f,
                                 tables), rows))
        scans = [_scan(p, f) for p in parts]
        diffs = np.split(_dc_diffs(np.concatenate([sc[:, 0] for sc in scans]),
                                   f), np.cumsum([len(sc) for sc in scans])[:-1])
        codes = list(pool.map(lambda a: _tokens(*a, f), zip(scans, diffs)))
        bits = np.cumsum([0] + [int(n.sum()) for _, n in codes])
        pad = -int(bits[-1]) % 8            # the last byte's 1-bits
        val, length = codes[-1]
        codes[-1] = (np.append(val, (1 << pad) - 1), np.append(length, pad))
        words = list(pool.map(lambda a: _pack(*a[0], int(a[1]) & 31),
                              zip(codes, bits)))
    stream = np.zeros(int(bits[-1] + pad) // 32 + 3, np.uint64)
    for part, at in zip(words, bits):
        stream[at >> 5:(at >> 5) + len(part)] |= part
    entropy = np.frombuffer(stream.astype(">u4").tobytes(), np.uint8)
    data = (_headers(h, w, f, tables, exif)
            + _stuff(entropy[:int(bits[-1] + pad) // 8]) + b"\xff\xd9")
    coefs = [np.concatenate([p[c] for p in parts]) for c in range(3)]
    return Written(data, h, w, subsampling, coefs, tables)


def _transform(rgb: np.ndarray, f: int, tables: list[np.ndarray]
               ) -> list[np.ndarray]:
    """Each component's quantised coefficients of a band of whole MCU
    rows: (block rows, block columns, 64) int16, zigzag order."""
    planes = rgb_to_ycc(rgb)
    if f == 2:
        # libjpeg's h2v2 downsampler: the sum of 2x2, + 1 or 2 by turns
        # along the row, >> 2.
        h, w = planes[1].shape
        bias = np.arange(w // 2) % 2 + 1
        planes[1:] = [(c.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
                       + bias) >> 2 for c in planes[1:]]
    out = []
    for plane, q in zip(planes, tables):
        # 8-bit samples bound each DC to -1024..1016 and each AC to about
        # +-842, inside baseline's categories with any table.
        blocks = _blocks(plane.astype(np.float64) - 128)
        spectrum = blocks.reshape(-1, 64) @ (_DCT2[ZIGZAG].T / q)
        # Where u and v are 0 or 4 a coefficient is a sum over 8 and often
        # lands on a half step exactly; snapped to 1e-9 first, it rounds
        # the same whichever order the product summed in (which the
        # band's size can change).
        out.append(np.rint(np.round(spectrum, 9)).astype(np.int16)
                   .reshape(*blocks.shape[:2], 64))
    return out


def component_planes(written: Written) -> list[np.ndarray]:
    """The uint8 Y, Cb and Cr planes at their own sizes (T.81 A.1.1):
    dequantised, the exact IDCT in float64, level-shifted, rounded half up
    and clamped."""
    f = SUBSAMPLING[written.subsampling]
    out = []
    for c, (coefs, q) in enumerate(zip(written.coefficients, written.tables)):
        spectrum = coefs.reshape(-1, 64) * q.astype(np.float64)
        pixels = _round_u8(spectrum @ _DCT2[ZIGZAG] + 128).reshape(
            *coefs.shape[:2], 8, 8)
        d = 1 if c == 0 else f
        out.append(_unblocks(pixels)[:-(-written.height // d),
                                     :-(-written.width // d)])
    return out


def upsample_h2v2(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """libjpeg's h2v2 fancy upsampling of a uint8 chroma plane to
    (height, width): each output 9:3:3:1 of its four nearest samples,
    summed as libjpeg does (3:1 down the rows, then 3:1 across with +8 on
    even and +7 on odd columns, >> 4), the edges replicated."""
    c = plane.astype(np.int32)
    up = np.concatenate([c[:1], c[:-1]])
    down = np.concatenate([c[1:], c[-1:]])
    rows = np.empty((2 * c.shape[0], c.shape[1]), np.int32)
    rows[0::2], rows[1::2] = 3 * c + up, 3 * c + down
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int32)
    out[:, 0::2] = (3 * rows + left + 8) >> 4
    out[:, 1::2] = (3 * rows + right + 7) >> 4
    return out[:height, :width].astype(np.uint8)


def decode(written: Written) -> np.ndarray:
    """The (H, W, 3) uint8 RGB image that `written` stands for."""
    y, cb, cr = component_planes(written)
    if written.subsampling == "4:2:0":
        cb, cr = (upsample_h2v2(p, written.height, written.width)
                  for p in (cb, cr))
    return ycc_to_rgb(y, cb, cr)
