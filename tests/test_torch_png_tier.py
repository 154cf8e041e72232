"""The port's PNG tiers against the JAX package's native tier.

The port binds `gip_png_encode`, `gip_png_decode` and `gip_png_decode16` of
native/src/gip_codec.cpp in its own library (utils/native_codec.py); the
JAX package's tier is the same sources, built here from `native/src` with
zlib and bound by the JAX package's own unedited binding: the same bytes
out of the encoder, the same pixels and the same refusals out of the
decoders.  The zlib tier (utils/image.py) reads through `gip_png_decode`
and `gip_png_decode16` where they accept the file and through its plain
path (`_png_samples`, `unfilter_plain`) where they do not: both give the
same pixels.
"""

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path

import numpy as np
import pytest

from gpu_image_processing_tpu.utils import image as jax_image
from gpu_image_processing_tpu.utils import native_codec as jax_native_codec
from gpu_image_processing_tpu_torch.core.files import ROOT_DIR
from gpu_image_processing_tpu_torch.ops.cuda import build
from gpu_image_processing_tpu_torch.utils import image as codec
from gpu_image_processing_tpu_torch.utils import native_codec

from .test_native_formats import _png_bytes
from .test_torch_codec import SAMPLES, _chunk as _codec_chunk
from .test_torch_codec import _filter_row, _pack, make_png

FIXTURES = Path(__file__).parent / "data" / "torch_formats"
_REFERENCE_SOURCES = ("gip_codec.cpp", "gip_formats.cpp", "gip_jpeg.cpp")

# The reference sources of the JAX package's native tier.
NATIVE_SRC = ROOT_DIR / "native" / "src"


def reference_library() -> str:
    """The JAX package's native library (codec, decoders, JPEG), built from
    native/src as its CMake build would, once per set of sources: the file
    lands in the temporary directory under a hash of them, so the test
    processes share one build."""
    try:
        cxx = build.cxx_path()
    except RuntimeError:
        pytest.skip("no C++ compiler: the reference library cannot be built")
    sources = [NATIVE_SRC / name for name in _REFERENCE_SOURCES]
    digest = hashlib.sha256(b"".join(
        p.read_bytes() for p in [*sources, NATIVE_SRC / "gip_limits.h"]))
    target = Path(tempfile.gettempdir()) / (
        f"gip_reference_codec-{digest.hexdigest()[:16]}.so")
    if not target.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", tmp,
                 *map(str, sources), "-lz"], capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return str(target)


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native codec tier, Pillow switched off."""
    monkeypatch.setenv("GIP_NATIVE_LIB", reference_library())
    monkeypatch.setattr(jax_native_codec, "_LIB", None)
    monkeypatch.setattr(jax_native_codec, "_SEARCHED", False)
    monkeypatch.setattr(jax_image, "PIL_AVAILABLE", False)
    assert jax_native_codec.available()
    return jax_native_codec


def _content(rng, kind: str, h: int, w: int, c: int) -> np.ndarray:
    if kind == "noise":
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ramp = np.stack([(x * 7 + y * 3 + 40 * k) % 256 for k in range(c)], -1)
    return (ramp + rng.integers(0, 3, (h, w, c))).astype(np.uint8)


SHAPES = [(13, 17), (1, 23), (19, 1), (1, 1), (40, 33)]


# -- encode ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("level", [1, 6])
def test_encode_bytes_equal_the_jax_tier(rng, jax_native, level, channels,
                                         shape, kind):
    img = _content(rng, kind, *shape, channels)
    got = native_codec.png_encode(img, level)
    assert got == jax_native.png_encode(img, level)
    np.testing.assert_array_equal(native_codec.png_decode(got), img)


@pytest.mark.parametrize("level", [0, 1, 2, 9])
def test_encode_levels_and_two_dimensional_input(rng, jax_native, level):
    img = _content(rng, "gradient", 31, 29, 1)[..., 0]
    got = native_codec.png_encode(img, level)
    assert got == jax_native.png_encode(img, level)
    # Level <= 1 writes Sub rows, level >= 2 None rows.
    lines = zlib.decompress(got[41:-12])
    assert lines[0] == (1 if level <= 1 else 0)


@pytest.mark.parametrize("level", [1, 6])
def test_two_channel_encode_round_trips_where_gip_refuses(rng, level):
    """Grey + alpha, which `gip_png_encode` refuses, is written as colour
    type 4 with filter None rows and reads back through every tier."""
    two = _content(rng, "noise", 13, 17, 2)
    buf, length = ctypes.c_void_p(), ctypes.c_size_t()
    assert native_codec.load().gip_png_encode(
        two.ctypes.data_as(ctypes.c_char_p), 13, 17, 2, level,
        ctypes.byref(buf), ctypes.byref(length)) != 0
    png = native_codec.png_encode(two, level)
    assert png[24:26] == bytes([8, 4])
    assert zlib.decompress(png[41:-12])[::1 + 2 * 17] == bytes(13)
    np.testing.assert_array_equal(native_codec.png_decode(png), two)
    np.testing.assert_array_equal(codec.decode_png(png), two)
    np.testing.assert_array_equal(codec.decode_png16(png),
                                  two.astype(np.uint16) * 257)


def test_encode_refuses_what_the_jax_tier_refuses(jax_native):
    for img in (np.zeros((0, 4, 3), np.uint8), np.zeros((4, 4, 5), np.uint8)):
        assert native_codec.png_encode(img) is None
        assert jax_native.png_encode(img) is None
    # Two channels, which gip_png_encode refuses, are grey + alpha here.
    two = np.arange(24, dtype=np.uint8).reshape(3, 4, 2)
    assert jax_native.png_encode(two) is None
    png = native_codec.png_encode(two)
    assert png[25] == 4
    np.testing.assert_array_equal(native_codec.png_decode(png), two)


# -- decode ----------------------------------------------------------------


def _both(jax_native, data: bytes):
    got, want = native_codec.png_decode(data), jax_native.png_decode(data)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("colour", [0, 2, 4, 6])
def test_decode_every_filter_type_equals_the_jax_tier(rng, jax_native, filt,
                                                      colour):
    for h, w in ((9, 13), (1, 7), (6, 1)):
        arr = rng.integers(0, 256, (h, w, SAMPLES[colour]), dtype=np.uint8)
        got = _both(jax_native, make_png(arr.reshape(h, -1), w, colour, filt=filt))
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("filt", [1, 3, 4, "mixed"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
def test_decode_depths_and_palettes_equal_the_jax_tier(rng, jax_native, filt,
                                                       depth):
    h, w = 7, 11
    values = rng.integers(0, 1 << depth, (h, w))
    if depth == 16:
        packed = values.astype(">u2").view(np.uint8).reshape(h, -1)
        _both(jax_native, make_png(packed, w, 0, depth, filt))
        rgb = rng.integers(0, 1 << 16, (h, w * 3))
        _both(jax_native, make_png(rgb.astype(">u2").view(np.uint8).reshape(h, -1),
                                   w, 2, depth, filt))
        return
    grey = _both(jax_native, make_png(_pack(values, depth), w, 0, depth, filt))
    np.testing.assert_array_equal(
        grey[..., 0], values * (255 // ((1 << depth) - 1)))
    palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
    for trns in (None, bytes(range(3))):
        extra = [(b"PLTE", palette.tobytes())]
        if trns is not None:
            extra.append((b"tRNS", trns[:1 << depth]))
        got = _both(jax_native, make_png(_pack(values, depth), w, 3, depth,
                                         filt, extra=extra))
        np.testing.assert_array_equal(got[..., :3], palette[values])
        assert got.shape[2] == (3 if trns is None else 4)


@pytest.mark.parametrize("colour,depth", [(0, 1), (0, 4), (0, 16), (2, 8),
                                          (2, 16), (3, 2), (4, 8), (6, 16)])
def test_decode_adam7_equals_the_jax_tier(rng, jax_native, colour, depth):
    for h, w in ((1, 1), (3, 2), (9, 8), (17, 13)):
        values = rng.integers(0, 1 << depth, (h, w, SAMPLES[colour]))
        palette = (rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
                   if colour == 3 else None)
        _both(jax_native, _png_bytes(values, depth, colour, interlace=1,
                                     palette=palette))


def test_decode_the_committed_fixtures_equals_the_jax_tier(jax_native):
    """PNG fixtures decode to the JAX tier's pixels; the other formats are
    refused by both, as they are not PNG."""
    names = sorted(p.name for p in FIXTURES.iterdir() if p.suffix != ".py"
                   and p.name != "expected.npz")
    assert sum(n.endswith(".png") for n in names) == 4
    for name in names:
        got = _both(jax_native, (FIXTURES / name).read_bytes())
        assert (got is not None) == name.endswith(".png"), name


def _filtered_png(values: np.ndarray, depth: int, colour: int,
                  interlace: int, extra=()) -> bytes:
    """PNG bytes of (H, W, S) sample values as libpng writes them: each
    pass's rows packed, then filtered None, Sub, Up, Average and Paeth in
    turn (row k of the file by filter k % 5), zlib level 6."""
    h, w, samples = values.shape
    bpp = max(1, samples * depth // 8)
    passes = codec.ADAM7 if interlace else ((0, 0, 1, 1),)
    lines, k = [], 0
    for x0, y0, dx, dy in passes:
        sub = values[y0::dy, x0::dx]
        if not sub.size:
            continue
        if depth == 16:
            packed = sub.astype(">u2").view(np.uint8).reshape(len(sub), -1)
        else:
            packed = _pack(sub.reshape(len(sub), -1), depth)
        prev = bytes(packed.shape[1])
        for row in packed:
            lines.append(_filter_row(k % 5, row.tobytes(), prev, bpp))
            prev, k = row.tobytes(), k + 1
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (codec.PNG_SIGNATURE + _codec_chunk(b"IHDR", ihdr)
            + b"".join(_codec_chunk(kind, p) for kind, p in extra)
            + _codec_chunk(b"IDAT", zlib.compress(b"".join(lines), 6))
            + _codec_chunk(b"IEND", b""))


#: Every colour type at every depth it allows, Adam7 off and on, palettes
#: with and without tRNS: (colour, depth, interlace, tRNS).
TIER_CASES = [(colour, depth, interlace, trns)
              for colour, depths in sorted(codec.DEPTHS.items())
              for depth in depths for interlace in (0, 1)
              for trns in ((False, True) if colour == 3 else (False,))]


def _tier_case(colour: int, depth: int, interlace: int, trns: bool) -> bytes:
    rng = np.random.default_rng(colour * 1000 + depth * 10 + interlace * 2
                                + trns)
    h, w = 19, 23
    values = rng.integers(0, 1 << depth, (h, w, SAMPLES[colour]))
    extra = []
    if colour == 3:
        # A palette short of the depth's range (200 entries at 8 bits), a
        # tRNS over half of it: entries past it are opaque.
        entries = min(1 << depth, 200)
        values %= entries
        extra.append((b"PLTE", rng.integers(0, 256, (entries, 3),
                                            dtype=np.uint8).tobytes()))
        if trns:
            extra.append((b"tRNS", bytes(range(1, 256, 3))[:max(1, entries // 2)]))
    return _filtered_png(values, depth, colour, interlace, extra)


@pytest.mark.parametrize("colour,depth,interlace,trns", TIER_CASES)
def test_zlib_tier_through_gip_equals_its_plain_path(jax_native, monkeypatch,
                                                     colour, depth, interlace,
                                                     trns):
    """The zlib tier through `gip_png_decode16` and `gip_png_decode` gives
    its plain path's pixels, at 16 and 8 bits; `png_decode` and
    `png_decode16` give the JAX native tier's."""
    data = _tier_case(colour, depth, interlace, trns)
    want16 = jax_native.png_decode16(data)
    assert want16 is not None
    np.testing.assert_array_equal(native_codec.png_decode(data),
                                  jax_native.png_decode(data))
    np.testing.assert_array_equal(native_codec.png_decode16(data), want16)
    through_gip = codec.decode_png(data), codec.decode_png16(data)
    np.testing.assert_array_equal(through_gip[1], want16)
    # The same tier with gip refusing every file: the plain path, one
    # unfilter a pass and a decode.
    passes = []
    real_unfilter = codec.unfilter_plain
    monkeypatch.setattr(native_codec, "png_decode", lambda data: None)
    monkeypatch.setattr(native_codec, "png_decode16", lambda data: None)
    monkeypatch.setattr(codec, "unfilter_plain",
                        lambda *args: passes.append(args[1])
                        or real_unfilter(*args))
    np.testing.assert_array_equal(codec.decode_png(data), through_gip[0])
    np.testing.assert_array_equal(codec.decode_png16(data), through_gip[1])
    assert len(passes) == 2 * (7 if interlace else 1)


def test_a_file_gip_refuses_decodes_through_the_plain_path(monkeypatch):
    """A tRNS chunk longer than the palette: gip_png_decode and
    gip_png_decode16 refuse it, the zlib tier reads it (as Pillow does)
    through `_png_samples` and `unfilter_plain`, its alpha cut to the
    palette."""
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    index = rng.integers(0, 4, (9, 11, 1))
    data = _filtered_png(index, 2, 3, 0, [(b"PLTE", palette.tobytes()),
                                           (b"tRNS", bytes([10, 20, 30, 40, 50]))])
    assert native_codec.png_decode(data) is None
    assert native_codec.png_decode16(data) is None
    rows = []
    real_unfilter = codec.unfilter_plain
    monkeypatch.setattr(codec, "unfilter_plain",
                        lambda *args: rows.append(args[1]) or real_unfilter(*args))
    np.testing.assert_array_equal(codec.decode_png(data), palette[index[..., 0]])
    rgba = np.hstack([palette, np.array([[10], [20], [30], [40]], np.uint8)])
    np.testing.assert_array_equal(codec.decode_png16(data),
                                  rgba[index[..., 0]].astype(np.uint16) * 257)
    assert rows == [9, 9]
    with pytest.raises(codec.ImageCodecError, match="CRC"):
        codec.decode_png(data[:-20] + bytes([data[-20] ^ 1]) + data[-19:])


def _chunk(kind: bytes, payload: bytes, crc=None) -> bytes:
    crc = zlib.crc32(kind + payload) if crc is None else crc
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def _png(ihdr=(4, 3, 8, 2, 0, 0, 0), chunks=None, lines=None) -> bytes:
    w, h = ihdr[0], ihdr[1]
    if chunks is None:
        if lines is None:
            lines = b"".join(b"\x00" + bytes(range(y, y + w * 3))
                             for y in range(h))
        chunks = [(b"IDAT", zlib.compress(lines))]
    return (codec.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + b"".join(_chunk(k, p) for k, p in chunks) + _chunk(b"IEND", b""))


def _palette_png(entries: int, trns: bytes | None = None, index: int = 0,
                 trns_first: bool = False) -> bytes:
    plte = (b"PLTE", bytes(range(256)) * 3 + bytes(3 * max(0, entries - 256))
            if entries > 256 else bytes(i * 7 % 256 for i in range(3 * entries)))
    chunks = [plte]
    if trns is not None:
        chunks.insert(0 if trns_first else 1, (b"tRNS", trns))
    lines = b"".join(b"\x00" + bytes([index] * 4) for _ in range(3))
    return _png((4, 3, 8, 3, 0, 0, 0), chunks + [(b"IDAT", zlib.compress(lines))])


REFUSALS = {
    "short": lambda: _png()[:44],
    "not a png": lambda: b"GIF89a" + bytes(60),
    "bad depth": lambda: _png((4, 3, 4, 2, 0, 0, 0)),
    "bad colour": lambda: _png((4, 3, 8, 5, 0, 0, 0)),
    "interlace 2": lambda: _png((4, 3, 8, 2, 0, 0, 2)),
    "zero width": lambda: _png((0, 3, 8, 2, 0, 0, 0)),
    "over the pixel cap": lambda: _png((1 << 15, 1 << 15, 8, 0, 0, 0, 0),
                                       chunks=[(b"IDAT", z)]),
    "no idat": lambda: _png(chunks=[]),
    "empty idat": lambda: _png(chunks=[(b"IDAT", b"")]),
    "short image data": lambda: _png(lines=bytes(12)),
    "long image data": lambda: _png(lines=bytes(13 * 3 + 1)),
    "garbage idat": lambda: _png(chunks=[(b"IDAT", b"\x78\x9c" + bytes(30))]),
    "truncated stream": lambda: _png(chunks=[(b"IDAT", zlib.compress(bytes(39))[:-5])]),
    "filter type 5": lambda: _png(lines=b"\x05" + bytes(12) + bytes(26)),
    "palette index past PLTE": lambda: _palette_png(2, index=2),
    "palette without PLTE": lambda: _png((4, 3, 8, 3, 0, 0, 0), chunks=[
        (b"IDAT", zlib.compress(bytes(15)))]),
    "257 palette entries": lambda: _palette_png(257),
    "tRNS past the palette": lambda: _palette_png(2, trns=b"\x01\x02\x03"),
    "tRNS before PLTE": lambda: _palette_png(2, trns=b"\x01", trns_first=True),
    "chunk past the end": lambda: (_png()[:33] + struct.pack(">I", 1000)
                                   + b"IDAT" + bytes(20)),
    "IHDR of 12 bytes": lambda: (codec.PNG_SIGNATURE
                                 + _chunk(b"IHDR", bytes(12)) + _png()[33:]),
}
ACCEPTED = {
    "bad CRC": lambda: _png()[:-4] + b"\x00\x00\x00\x00",
    "bad IDAT CRC": lambda: _png(chunks=[(b"IDAT", zlib.compress(
        b"".join(b"\x00" + bytes(12) for _ in range(3))))])[:-16] + b"\xde\xad\xbe\xef"
        + _chunk(b"IEND", b""),
    "no IEND": lambda: _png()[:-12],
    "bytes after IEND": lambda: _png() + b"trailing bytes",
    "split IDAT": lambda: _png(chunks=[(b"IDAT", z[:7]), (b"IDAT", z[7:])]),
    "ancillary chunks": lambda: _png(chunks=[(b"tEXt", b"k\x00v"),
                                             (b"gAMA", bytes(4)),
                                             (b"IDAT", z)]),
    "tRNS on RGB": lambda: _png(chunks=[(b"tRNS", bytes(6)), (b"IDAT", z)]),
    "empty tRNS on a palette": lambda: _palette_png(2, trns=b""),
    "256 palette entries": lambda: _palette_png(256, index=255),
}
z = zlib.compress(b"".join(b"\x00" + bytes(range(y, y + 12)) for y in range(3)))


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_decode_refuses_where_the_jax_tier_refuses(jax_native, case):
    data = REFUSALS[case]()
    assert jax_native.png_decode(data) is None, case
    assert native_codec.png_decode(data) is None


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_decode_accepts_what_the_jax_tier_accepts(jax_native, case):
    data = ACCEPTED[case]()
    assert jax_native.png_decode(data) is not None, case
    _both(jax_native, data)


@pytest.mark.parametrize("seed", range(8))
def test_decode_of_damaged_pngs_agrees_with_the_jax_tier(jax_native, seed):
    """Bytes flipped anywhere in a PNG: both tiers refuse it or both read
    the same pixels."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    good = make_png(arr.reshape(6, -1), 9, 2, filt="mixed")
    refused = 0
    for _ in range(60):
        data = bytearray(good)
        for pos in rng.integers(8, len(data), rng.integers(1, 4)):
            data[pos] = int(rng.integers(0, 256))
        refused += _both(jax_native, bytes(data)) is None
    assert 0 < refused < 60


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_what_png_encode_writes_decodes_in_both_tiers(rng, jax_native, channels):
    img = _content(rng, "noise", 23, 19, channels)
    for level in (1, 6):
        png = native_codec.png_encode(img, level)
        np.testing.assert_array_equal(_both(jax_native, png), img)
        np.testing.assert_array_equal(codec.decode_png(png), img)


# -- the server's routing ------------------------------------------------------


def test_uploads_go_native_first_as_in_the_jax_package(rng, jax_native):
    """A PNG upload is the native tier's pixels and counts `native_png`, as
    the JAX package's routing without Pillow does."""
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    url = "data:image/png;base64," + __import__("base64").b64encode(
        native_codec.png_encode(img)).decode()
    before = codec.decode_tier_counts()
    got, passthrough = codec.decode_base64_image_ex(url)
    after = codec.decode_tier_counts()
    np.testing.assert_array_equal(got, jax_image.decode_base64_image(url))
    assert passthrough == url
    assert after["native_png"] == before["native_png"] + 1
    assert {k for k in after if after[k] != before[k]} == {"native_png"}


def test_answers_are_the_native_tiers_bytes(rng, jax_native):
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    assert codec.encode_png(img) == jax_native.png_encode(img, 1)
    assert codec.encode_image_to_base64(img) == jax_image.encode_image_to_base64(img)
