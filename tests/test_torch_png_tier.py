"""The port's native PNG tier (utils/native_codec.py `png_encode`,
`png_decode`, over ops/cuda/png_codec.cpp and Python's zlib) against the JAX
package's native tier (`gip_png_encode`/`gip_png_decode` of
native/src/gip_codec.cpp), built here from `native/src` with zlib and bound
by the JAX package's own unedited binding: the same bytes out of the
encoder, the same pixels and the same refusals out of the decoder.
"""

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
from .test_torch_codec import SAMPLES, _pack, make_png

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


def test_filter_rows_are_sub_or_none(rng):
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    sub = native_codec.png_filter_rows(img, 1)
    assert (sub[:, 0] == 1).all()
    rows = img.reshape(5, 21)
    want = rows.copy()
    want[:, 3:] -= rows[:, :-3]
    np.testing.assert_array_equal(sub[:, 1:], want)
    none = native_codec.png_filter_rows(img, 2)
    assert (none[:, 0] == 0).all()
    np.testing.assert_array_equal(none[:, 1:], rows)


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
    return (native_codec.PNG_SIGNATURE
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
    "IHDR of 12 bytes": lambda: (native_codec.PNG_SIGNATURE
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
