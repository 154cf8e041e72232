"""The JPEG yardstick: the plain writer's files read by the port's native
decoder and by Pillow within the decode tolerance of the reference decode,
at both subsamplings, with and without Exif, at odd sizes; its pieces
against loop versions; and the decode faults the tolerance has to refuse.

`DECODE_TOL` is the tolerance a configuration with JPEG uploads states
(`numerics.within_tolerance.jpeg_decode`), set from readings on the
dead-leaves scene at quality 75 and 90, both subsamplings: the native
decoder differs from the reference decode by at most 3, on at most 6.2%
of the bytes from 640x480 to 4032x3024 (13.7% at 53x37), Pillow
(libjpeg-turbo) by at most 3 on at most 7.1%; a decoder with Cb and Cr
swapped, with nearest chroma upsampling, or off by one step of quality
differs by 14 or more, on 43% of the bytes or more.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from portbench.harness.check import Comparison
from portbench.inputs import scene
from portbench.reference import jpeg

DECODE_TOL = {"max_diff": 4, "max_share_pct": 20.0}
NUMERICS = {"within_tolerance": {"jpeg_decode": DECODE_TOL}}
SIZES = [(37, 53), (16, 16), (7, 9), (1, 1), (129, 77)]


def _image(shape: tuple[int, int], seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if min(shape) < 16:
        return rng.integers(0, 256, (*shape, 3), np.uint8)
    return scene.scene_image(rng, (*shape, 3))


def _within(got: np.ndarray, want: np.ndarray) -> Comparison:
    cmp = Comparison(NUMERICS)
    cmp.add_decode(torch.from_numpy(np.array(got)),
                   torch.from_numpy(want))
    return cmp


def _assert_within(got: np.ndarray, want: np.ndarray) -> None:
    numbers = _within(got, want).numbers()
    assert numbers["decode_bytes_beyond_tol"]["value"] == 0, numbers
    assert (numbers["decode_worst_share_pct"]["value"]
            <= numbers["decode_worst_share_pct"]["limit"]), numbers


CASES = [(shape, sub, exif) for shape in SIZES
         for sub in ("4:4:4", "4:2:0") for exif in (True, False)]


@pytest.mark.parametrize("shape,subsampling,exif", CASES)
def test_the_native_decoder_reads_the_writer_within_tolerance(
        shape, subsampling, exif):
    from gpu_image_processing_tpu_torch.utils import native_codec

    written = jpeg.encode(_image(shape), 90, subsampling, exif)
    got = native_codec.jpeg_decode(written.data)
    assert got is not None and got.shape == (*shape, 3)
    _assert_within(got, jpeg.decode(written))


@pytest.mark.parametrize("shape,subsampling,exif", CASES)
def test_pillow_reads_the_writer_within_tolerance(shape, subsampling, exif):
    image = pytest.importorskip("PIL.Image")
    written = jpeg.encode(_image(shape), 90, subsampling, exif)
    got = np.asarray(image.open(io.BytesIO(written.data)).convert("RGB"))
    _assert_within(got, jpeg.decode(written))


@pytest.mark.parametrize("quality", [1, 50, 75, 100])
def test_every_quality_reads_back(quality):
    from gpu_image_processing_tpu_torch.utils import native_codec

    for subsampling in ("4:4:4", "4:2:0"):
        written = jpeg.encode(_image((37, 53), quality), quality, subsampling)
        _assert_within(native_codec.jpeg_decode(written.data),
                       jpeg.decode(written))


def test_the_exif_segment_is_what_a_phone_writes_and_the_port_decodes_it():
    """APP1 Exif with Orientation 1 right after SOI; the port's rule then
    refuses to pass the upload through, so its reply shows its decode."""
    from gpu_image_processing_tpu_torch.utils.image import (
        _jpeg_headers_neutral)

    img = _image((37, 53))
    with_exif = jpeg.encode(img, 90, "4:2:0", True).data
    without = jpeg.encode(img, 90, "4:2:0", False).data
    assert with_exif[2:4] == b"\xff\xe1" and with_exif[6:12] == b"Exif\0\0"
    assert b"\x01\x12\x00\x03\x00\x00\x00\x01\x00\x01" in with_exif[:64]
    assert without[2:4] == b"\xff\xe0" and without[6:11] == b"JFIF\0"
    assert not _jpeg_headers_neutral(with_exif)
    assert _jpeg_headers_neutral(without)


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
def test_the_bytes_do_not_depend_on_the_bands(monkeypatch, subsampling):
    img = _image((133, 211), 5)
    monkeypatch.setattr(jpeg, "THREADS", 1)
    one = jpeg.encode(img, 90, subsampling)
    for bands in (2, 5, 7, 9):
        monkeypatch.setattr(jpeg, "THREADS", bands)
        many = jpeg.encode(img, 90, subsampling)
        assert one.data == many.data, bands
        for a, b in zip(one.coefficients, many.coefficients):
            np.testing.assert_array_equal(a, b)


def test_the_writer_refuses_what_it_cannot_write():
    with pytest.raises(jpeg.JPEGError):
        jpeg.encode(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(jpeg.JPEGError):
        jpeg.encode(np.zeros((4, 4, 3), np.uint8), subsampling="4:2:2")
    with pytest.raises(jpeg.JPEGError):
        jpeg.encode(np.zeros((4, 4, 3), np.uint8), quality=0)


def test_the_packer_is_a_plain_bit_string():
    """`_pack` against the codes written out bit by bit."""
    rng = np.random.default_rng(3)
    length = rng.integers(0, 28, 2000)
    val = rng.integers(0, 2**27, 2000) & ((1 << length) - 1)
    for lead in (0, 5, 31):
        words = jpeg._pack(val.copy(), length.copy(), lead)
        bits = "0" * lead + "".join(
            format(int(v), f"0{n}b") if n else "" for v, n in zip(val, length))
        want = int(bits.ljust(32 * len(words), "0"), 2)
        got = int("".join(format(int(w), "032b") for w in words), 2)
        assert got == want, lead


def _upsample_loop(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2_fancy_upsample, transcribed a sample at a time."""
    h, w = c.shape
    c = c.astype(int)
    out = np.zeros((2 * h, 2 * w), int)
    for y in range(h):
        for v, near in ((0, max(y - 1, 0)), (1, min(y + 1, h - 1))):
            col = [3 * c[y, x] + c[near, x] for x in range(w)]
            for x in range(w):
                if w == 1:
                    out[2 * y + v, 0] = (col[0] * 4 + 8) >> 4
                    out[2 * y + v, 1] = (col[0] * 4 + 7) >> 4
                    continue
                left = col[x - 1] if x > 0 else col[0]
                right = col[x + 1] if x < w - 1 else col[w - 1]
                out[2 * y + v, 2 * x] = (3 * col[x] + left + 8) >> 4
                out[2 * y + v, 2 * x + 1] = (3 * col[x] + right + 7) >> 4
    return out


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (9, 4)])
def test_the_upsampler_is_libjpegs_fancy_one(shape):
    c = np.random.default_rng(shape[0]).integers(0, 256, shape, np.uint8)
    full = _upsample_loop(c)
    np.testing.assert_array_equal(
        jpeg.upsample_h2v2(c, 2 * shape[0] - 1, 2 * shape[1]),
        full[:2 * shape[0] - 1])


def test_the_reference_idct_of_a_flat_block_is_flat():
    written = jpeg.encode(np.full((8, 8, 3), 77, np.uint8), 100, "4:4:4")
    np.testing.assert_array_equal(jpeg.decode(written), 77)


def _faults(written: jpeg.Written, img: np.ndarray, quality: int) -> dict:
    """What a decoder with each planted fault makes of `written`."""
    y, cb, cr = jpeg.component_planes(written)
    h, w = written.height, written.width
    sub = written.subsampling

    def up(p):
        return jpeg.upsample_h2v2(p, h, w) if sub == "4:2:0" else p

    out = {"swapped_chroma": jpeg.ycc_to_rgb(y, up(cr), up(cb)),
           "quality_one_step_off": jpeg.decode(
               jpeg.encode(img, quality - 1, sub))}
    if sub == "4:2:0":
        def nearest(p):
            return np.repeat(np.repeat(p, 2, 0), 2, 1)[:h, :w]
        out["nearest_chroma"] = jpeg.ycc_to_rgb(y, nearest(cb), nearest(cr))
    return out


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("shape", [(37, 53), (64, 96)])
def test_every_decode_fault_is_refused(subsampling, shape):
    img = _image(shape, 23)
    written = jpeg.encode(img, 90, subsampling)
    want = jpeg.decode(written)
    for name, got in _faults(written, img, 90).items():
        numbers = _within(got, want).numbers()
        assert numbers["decode_bytes_beyond_tol"]["value"] > 0, (name, numbers)
