"""The banded PNG encoder of the serving path (ops/cuda/png_bands.cpp,
`native_codec.png_encode_bands`, `utils/image.py::encode_png_banded`).

Its PNGs hold the pixels of `native_codec.png_encode(img, 1)` for every band
count, read back by three readers that share none of its code: gip's
decoder, the zlib tier (every chunk's CRC) with Python's zlib (the stream's
Adler-32) over the Sub rows, and the benchmark's plain reader.  The bytes
depend on the image and the band count alone; one band is `png_encode`'s
bytes, and more bands cost a few bytes each.
"""

import base64
import os
import struct
import sys
import threading
import zlib

import numpy as np
import pytest

from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.server.app import create_app, warm_kernels
from gpu_image_processing_tpu_torch.server.http import Request
from gpu_image_processing_tpu_torch.utils import image as codec
from gpu_image_processing_tpu_torch.utils import native_codec
from portbench.inputs.scene import scene_image
from portbench.reference import png as reference_png

#: The smallest answer of two bands: 1024 rows of 1366 RGB pixels are
#: 4,197,376 row bytes, two `BAND_BYTES`.
LARGE = (1024, 1366, 3)
JOIN_S = 60


def _content(rng, kind: str, h: int, w: int, c: int) -> np.ndarray:
    if kind == "noise":
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    ramp = np.stack([(x * 7 + y * 3 + 40 * k) % 256 for k in range(c)], -1)
    return (ramp + rng.integers(0, 3, (h, w, c))).astype(np.uint8)


def _idat(png: bytes) -> bytes:
    """The zlib stream of a PNG: its IDAT payloads joined, CRCs checked."""
    pos, stream = 8, []
    while pos < len(png):
        length, kind = struct.unpack(">I4s", png[pos:pos + 8])
        payload = png[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", png[pos + 8 + length:pos + 12 + length])
        assert zlib.crc32(kind + payload) == crc, kind
        if kind == b"IDAT":
            stream.append(payload)
        pos += 12 + length
    return b"".join(stream)


def _sub_rows(img: np.ndarray) -> bytes:
    """The Sub-filtered scanlines `gip_png_encode` deflates at level 1."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    lines = np.empty((h, w * c + 1), np.uint8)
    lines[:, 0] = 1
    lines[:, 1:1 + c] = rows[:, :c]
    lines[:, 1 + c:] = rows[:, c:] - rows[:, :-c]
    return lines.tobytes()


def _large_answer(seed: int) -> np.ndarray:
    return scene_image(np.random.default_rng(seed), LARGE)


@pytest.fixture
def four_cores(monkeypatch):
    """The band count of a host with four usable cores, whatever this
    host has."""
    monkeypatch.setattr(codec, "usable_cores", lambda: 4)


# -- the library ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("shape,bands", [
    ((13, 17), 2),      # 13 rows into bands of 6 and 7
    ((29, 23), 3),      # 9, 10, 10
    ((31, 8), 4),
    ((40, 33), 7),
    ((6, 9), 50),       # more bands asked than rows: one a row
    ((19, 1), 4),       # width 1
    ((1, 23), 3),       # one row: one band
])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bands_decode_to_the_pixels_by_every_reader(rng, channels, shape,
                                                    bands, kind):
    img = _content(rng, kind, *shape, channels)
    png = native_codec.png_encode_bands(img, bands)
    np.testing.assert_array_equal(native_codec.png_decode(png), img)
    np.testing.assert_array_equal(codec.decode_png(png), img)
    np.testing.assert_array_equal(reference_png.decode(png), img)
    # Python's zlib checks the joined Adler-32; the rows are the Sub rows.
    assert zlib.decompress(_idat(png)) == _sub_rows(img)


def test_bands_beyond_the_rows_are_one_a_row(rng):
    img = _content(rng, "noise", 7, 11, 3)
    assert (native_codec.png_encode_bands(img, 50)
            == native_codec.png_encode_bands(img, 7))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("shape", [(13, 17), (1, 23), (19, 1), (40, 33)])
def test_one_band_is_png_encodes_bytes(rng, shape, channels):
    img = _content(rng, "gradient", *shape, channels)
    assert (native_codec.png_encode_bands(img, 1)
            == native_codec.png_encode(img, 1))


@pytest.mark.parametrize("bands", [2, 3, 8])
def test_the_bytes_repeat_across_calls_and_threads(rng, bands):
    img = _content(rng, "noise", 257, 301, 3)
    first = native_codec.png_encode_bands(img, bands)
    assert native_codec.png_encode_bands(img, bands) == first
    got = [None] * 4

    def encode(i):
        got[i] = native_codec.png_encode_bands(img, bands)

    threads = [threading.Thread(target=encode, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()
    assert got == [first] * 4


@pytest.mark.parametrize("bands", [2, 4, 8, 9])
def test_more_bands_cost_under_five_hundredths_of_a_percent(bands):
    img = scene_image(np.random.default_rng(2024), (600, 800, 3))
    one = len(native_codec.png_encode(img, 1))
    got = native_codec.png_encode_bands(img, bands)
    assert abs(len(got) - one) <= 0.0005 * one
    np.testing.assert_array_equal(native_codec.png_decode(got), img)


@pytest.mark.parametrize("img,bands", [
    (np.zeros((4, 4, 2), np.uint8), 2),    # grey + alpha: png_encode's own
    (np.zeros((4, 4, 5), np.uint8), 2),
    (np.zeros((0, 4, 3), np.uint8), 2),
    (np.zeros((4, 4, 3), np.uint8), 0),
])
def test_what_the_library_refuses(img, bands):
    assert native_codec.png_encode_bands(img, bands) is None


# -- the serving encoder ----------------------------------------------------


@pytest.mark.parametrize("shape,cores,bands", [
    ((2146, 3239, 3), 8, 8),     # the UI cell's answer: 9 by size
    ((2146, 3239, 3), 16, 9),
    ((2146, 3239, 3), 1, 1),
    ((1024, 1366, 3), 8, 2),     # two bands' worth
    ((1023, 1366, 3), 8, 1),     # a row short of it
    ((2048, 2048, 1), 8, 2),
    ((2048, 2048, 4), 8, 8),
])
def test_band_count_follows_the_size_and_the_cores(monkeypatch, shape, cores,
                                                   bands):
    monkeypatch.setattr(codec, "usable_cores", lambda: cores)
    assert codec.band_count(*shape) == bands


def test_usable_cores_lie_within_the_affinity():
    assert 1 <= codec.usable_cores() <= len(os.sched_getaffinity(0))


@pytest.mark.parametrize("img", [
    np.arange(12 * 10 * 3, dtype=np.uint8).reshape(12, 10, 3),
    np.arange(12 * 10, dtype=np.uint8).reshape(12, 10),
    np.arange(12 * 10 * 2, dtype=np.uint8).reshape(12, 10, 2),
], ids=["rgb", "two_dimensional", "grey_alpha"])
def test_a_small_answer_keeps_encode_pngs_bytes(img):
    before = codec.encode_band_counts()
    assert codec.encode_png_banded(img) == codec.encode_png(img)
    after = codec.encode_band_counts()
    assert after == {**before, "encodes": before["encodes"] + 1}


def test_a_large_answer_is_banded_and_counted(four_cores):
    img = _large_answer(5)
    before = codec.encode_band_counts()
    png = codec.encode_png_banded(img)
    after = codec.encode_band_counts()
    assert png == native_codec.png_encode_bands(img, 2)
    assert png != codec.encode_png(img)
    np.testing.assert_array_equal(reference_png.decode(png), img)
    assert after == {"encodes": before["encodes"] + 1,
                     "banded": before["banded"] + 1,
                     "bands": before["bands"] + 2}


def test_the_counter_loses_no_encode_across_threads(monkeypatch):
    # A band count of 2 on tiny images: the library runs, the counter is
    # read and written by every thread at once.
    monkeypatch.setattr(codec, "band_count", lambda h, w, c: 2)
    img = np.arange(8 * 6 * 3, dtype=np.uint8).reshape(8, 6, 3)
    want = native_codec.png_encode_bands(img, 2)
    workers, calls = 16, 25
    before = codec.encode_band_counts()
    bad = []

    def encode():
        for _ in range(calls):
            if codec.encode_png_banded(img) != want:
                bad.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=encode) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    after = codec.encode_band_counts()
    n = workers * calls
    assert not bad
    assert after == {"encodes": before["encodes"] + n,
                     "banded": before["banded"] + n,
                     "bands": before["bands"] + 2 * n}


# -- the server -------------------------------------------------------------


def _data_url(img: np.ndarray) -> str:
    return ("data:image/png;base64,"
            + base64.b64encode(native_codec.png_encode(img)).decode())


def _png(data_url: str) -> bytes:
    return base64.b64decode(data_url.split(",", 1)[1])


def test_stats_count_the_banded_answers(four_cores):
    rt = FilterRuntime("cpu")
    app = create_app(rt)

    def stats():
        return app.dispatch(Request(method="GET", path="/api/stats"))[1]

    def process(img):
        status, body = app.dispatch(Request(
            method="POST", path="/api/process",
            json={"image": _data_url(img), "filter": "box", "radius": 1,
                  "level": 2}))
        assert status == 200
        return body

    small = _content(np.random.default_rng(1), "noise", 16, 20, 3)
    was = stats()["encode_bands"]
    process(small)
    after_small = stats()["encode_bands"]
    assert after_small == {**was, "encodes": was["encodes"] + 1}
    large = _large_answer(9)
    body = process(large)
    after_large = stats()["encode_bands"]
    assert after_large == {"encodes": was["encodes"] + 2,
                           "banded": was["banded"] + 1,
                           "bands": was["bands"] + 2}
    want, _ = rt.run("box", large, radius=1, level=2)
    np.testing.assert_array_equal(
        native_codec.png_decode(_png(body["processed_image"])), want)


@pytest.mark.parametrize("filt", ["gaussian", "sobel"])
def test_process_all_levels_decode_to_the_runtimes_pixels(four_cores, filt):
    rt = FilterRuntime("cpu")
    app = create_app(rt)
    large = _large_answer(11)
    status, body = app.dispatch(Request(
        method="POST", path="/api/process-all",
        json={"image": _data_url(large), "filter": filt, "sigma": 2.0,
              "radius": 3}))
    assert status == 200
    # The original passes through as the upload's own bytes.
    assert _png(body["original_image"]) == native_codec.png_encode(large)
    for level in (1, 2):
        png = _png(body["results"][f"level_{level}"]["processed_image"])
        want, _ = rt.run(filt, large, sigma=2.0, radius=3, level=level) \
            if filt == "gaussian" else rt.run(filt, large, level=level)
        assert png == native_codec.png_encode_bands(want, 2)
        np.testing.assert_array_equal(codec.decode_png(png), want)
        np.testing.assert_array_equal(reference_png.decode(png), want)


def test_warm_kernels_runs_the_banded_encoder(monkeypatch):
    ran = []
    encode = native_codec.png_encode_bands
    monkeypatch.setattr(native_codec, "png_encode_bands", lambda img, b: (
        ran.append((img.shape, b)), encode(img, b))[1])
    before = codec.encode_band_counts()
    warm_kernels(FilterRuntime("cpu"))
    assert ran == [((8, 8, 3), 2)]
    # The warm-up is no answer: the counter is the requests'.
    assert codec.encode_band_counts() == before
