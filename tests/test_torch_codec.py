"""The port's PNG codec (utils/image.py) against the JAX package's
(Pillow-backed) codec: the same PNG bytes, decoded by both, must give the
same pixels.

The PNGs are written here, by a small encoder that applies one chosen
scanline filter (or all five in turn), so every filter type and colour type
is exercised.  The C++ unfilter helper needs nvcc, present only on the
card's host: its test is marked `cuda`; elsewhere the codec decodes with the
helper's plain version.
"""

import base64
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gpu_image_processing_tpu.utils import image as jax_codec
from gpu_image_processing_tpu_torch.ops.cuda import build
from gpu_image_processing_tpu_torch.utils import image as codec

FILTERS = [0, 1, 2, 3, 4, "mixed"]
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prev, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][kind]
        out[i] = (x - pred) & 0xFF
    return bytes([kind]) + bytes(out)


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def make_png(packed, width, colour, depth=8, filt=0, extra=(), interlace=0):
    """PNG bytes of packed scanlines (height, row_bytes) uint8."""
    height, row_bytes = packed.shape
    bpp = max(1, SAMPLES[colour] * depth // 8)
    prev = bytes(row_bytes)
    lines = []
    for y in range(height):
        row = packed[y].tobytes()
        kind = y % 5 if filt == "mixed" else filt
        lines.append(_filter_row(kind, row, prev, bpp))
        prev = row
    ihdr = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(k, p) for k, p in extra)
            + _chunk(b"IDAT", zlib.compress(b"".join(lines), 9))
            + _chunk(b"IEND", b""))


def _b64(png, prefix=True):
    text = base64.b64encode(png).decode()
    return "data:image/png;base64," + text if prefix else text


def _pack(values, depth):
    """(H, W) sample values of `depth` bits -> packed (H, row_bytes)."""
    if depth == 8:
        return values.astype(np.uint8)
    h, w = values.shape
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = values
    groups = padded.reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (groups << shifts).sum(axis=2, dtype=np.uint8)


def _both_decode(png):
    got = codec.decode_base64_image(_b64(png))
    want = jax_codec.decode_base64_image(_b64(png))
    return got, want


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("colour", [0, 2, 4, 6])
@pytest.mark.parametrize("shape", [(9, 13), (1, 7), (6, 1)])
def test_decode_matches_jax_codec(rng, filt, colour, shape):
    h, w = shape
    samples = SAMPLES[colour]
    arr = rng.integers(0, 256, size=(h, w, samples), dtype=np.uint8)
    png = make_png(arr.reshape(h, w * samples), w, colour, filt=filt)
    got, want = _both_decode(png)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if colour == 2:
        np.testing.assert_array_equal(got, arr)
    # The plain unfilter served this call; the raw decode keeps channels.
    np.testing.assert_array_equal(codec.decode_png(png), arr)


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True])
def test_palette_decode_matches_jax_codec(rng, filt, depth, trns):
    """Palette PNGs of every depth decode as the JAX codec decodes them:
    through PLTE, tRNS dropped."""
    h, w = 7, 11
    n = 1 << depth
    palette = rng.integers(0, 256, size=(n, 3), dtype=np.uint8)
    idx = rng.integers(0, n, size=(h, w))
    extra = [(b"PLTE", palette.tobytes())]
    if trns:
        extra.append((b"tRNS", bytes(range(0, 256, max(1, 256 // n)))[:n]))
    png = make_png(_pack(idx, depth), w, 3, depth=depth, filt=filt, extra=extra)
    got, want = _both_decode(png)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, palette[idx])


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_grey_matches_jax_codec(rng, depth):
    """1-, 2- and 4-bit grey PNGs decode as the JAX codec decodes them,
    scaled to 0-255."""
    h, w = 5, 13
    values = rng.integers(0, 1 << depth, size=(h, w))
    png = make_png(_pack(values, depth), w, 0, depth=depth, filt="mixed")
    got, want = _both_decode(png)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 0], values * (255 // ((1 << depth) - 1)))


def test_grey_trns_is_ignored_as_jax_does(rng):
    arr = rng.integers(0, 256, size=(4, 6), dtype=np.uint8)
    png = make_png(arr, 6, 0, extra=[(b"tRNS", b"\x00\x10")])
    got, want = _both_decode(png)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(9, 13), (1, 5), (5, 1)])
def test_encode_round_trips_through_both_codecs(rng, channels, shape):
    arr = rng.integers(0, 256, size=(*shape, channels), dtype=np.uint8)
    url = codec.encode_image_to_base64(arr)
    assert url.startswith("data:image/png;base64,")
    png = base64.b64decode(url.split(",", 1)[1])
    np.testing.assert_array_equal(
        np.array(Image.open(io.BytesIO(png))).reshape(arr.shape), arr)
    np.testing.assert_array_equal(codec.decode_png(png), arr)
    # The JAX codec's PNG decodes to the same pixels through the port.
    jax_png = base64.b64decode(
        jax_codec.encode_image_to_base64(arr).split(",", 1)[1])
    np.testing.assert_array_equal(codec.decode_png(jax_png), arr)


def test_base64_without_data_url_prefix(rng):
    arr = rng.integers(0, 256, size=(4, 5, 3), dtype=np.uint8)
    png = make_png(arr.reshape(4, 15), 5, 2)
    np.testing.assert_array_equal(
        codec.decode_base64_image(_b64(png, prefix=False)), arr)


def _png_depth(depth):
    """An RGB PNG whose header declares `depth` bits a sample."""
    png = bytearray(make_png(np.zeros((2, 6), np.uint8), 2, 2))
    png[24] = depth
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))
    return bytes(png)


@pytest.mark.parametrize("payload,match", [
    (lambda rng: _b64(make_png(np.zeros((3, 9), np.uint8), 3, 2)[:45]),
     "truncated"),
    (lambda rng: _b64(_png_depth(4)), "bit depth 4 and colour type 2"),
    (lambda rng: "not base64 at all!", "Failed to decode image"),
    (lambda rng: "", "empty"),
    (lambda rng: _b64(b"\x89PNG\r\n\x1a\n" + bytes(4)), "PNG without IEND"),
    (lambda rng: _b64(b"plain text, not an image at all"),
     "unrecognised image format"),
])
def test_refusals_name_png(rng, payload, match):
    """Undecodable uploads are refused with a message naming what failed."""
    with pytest.raises(codec.ImageCodecError, match=match):
        codec.decode_base64_image(payload(rng))


def test_corrupt_png_is_refused(rng):
    png = bytearray(make_png(np.zeros((3, 9), np.uint8), 3, 2))
    png[-20] ^= 0xFF  # inside IDAT: its CRC no longer holds
    with pytest.raises(codec.ImageCodecError, match="CRC"):
        codec.decode_png(bytes(png))
    with pytest.raises(codec.ImageCodecError, match="truncated|IEND"):
        codec.decode_png(bytes(png[:40]))
    with pytest.raises(codec.ImageCodecError, match="truncated"):
        codec.decode_png(bytes(png[:45]))


def test_passthrough_only_for_neutral_rgb_png(rng):
    arr = rng.integers(0, 256, size=(4, 5, 3), dtype=np.uint8)
    rows = arr.reshape(4, 15)
    neutral = make_png(rows, 5, 2, extra=[(b"tEXt", b"k\x00v")])
    img, passthrough = codec.decode_base64_image_ex(_b64(neutral))
    np.testing.assert_array_equal(img, arr)
    assert passthrough == _b64(neutral)
    for png in (make_png(rows, 5, 2, extra=[(b"gAMA", b"\x00\x00\xb1\x8f")]),
                make_png(np.dstack([arr, arr[..., :1]]).reshape(4, 20), 5, 6)):
        assert codec.decode_base64_image_ex(_b64(png))[1] is None


@pytest.mark.parametrize("colour", [0, 2, 3, 6])
def test_upload_decode_matches_jax(rng, colour):
    h, w = 6, 7
    extra = ()
    if colour == 3:
        palette = rng.integers(0, 256, size=(16, 3), dtype=np.uint8)
        extra = [(b"PLTE", palette.tobytes())]
        arr = rng.integers(0, 16, size=(h, w, 1), dtype=np.uint8)
    else:
        arr = rng.integers(0, 256, size=(h, w, SAMPLES[colour]), dtype=np.uint8)
    png = make_png(arr.reshape(h, -1), w, colour, extra=extra)
    got = codec.load_image_file(png)
    want = jax_codec.load_image_file(png)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("has_nvcc", [False, True])
def test_host_unfilter_is_chosen_once_from_nvcc(monkeypatch, has_nvcc):
    def nvcc_path():
        if not has_nvcc:
            raise RuntimeError("nvcc not found")
        return "/usr/bin/nvcc"

    monkeypatch.setattr(codec.build, "nvcc_path", nvcc_path)
    monkeypatch.setattr(codec, "_HOST_UNFILTER", None)
    want = codec.unfilter_native if has_nvcc else codec.unfilter_plain
    assert codec.host_unfilter() is want
    monkeypatch.setattr(codec.build, "nvcc_path", None)   # not asked again
    assert codec.host_unfilter() is want


@pytest.mark.cuda
def test_native_unfilter_matches_plain(rng):
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc, present on the card's host")
    if not torch.cuda.is_available():
        pytest.skip("needs the card's host")
    for bpp in (1, 2, 3, 4):
        height, row_bytes = 9, 5 * bpp
        raw = rng.integers(0, 256, size=(height, row_bytes + 1), dtype=np.uint8)
        raw[:, 0] = np.arange(height) % 5
        np.testing.assert_array_equal(
            codec.unfilter_native(raw.reshape(-1), height, row_bytes, bpp),
            codec.unfilter_plain(raw.reshape(-1), height, row_bytes, bpp))
    bad = np.zeros((2, 4), np.uint8)
    bad[1, 0] = 7
    with pytest.raises(codec.ImageCodecError, match="row 1"):
        codec.unfilter_native(bad.reshape(-1), 2, 3, 1)
