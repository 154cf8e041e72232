"""The image-file writers and readers of utils/image_io.py against the JAX
package's native ones (`gip_ppm_write`, `gip_bmp_write`, `gip_tga_write`,
`gip_ppm_read`, `gip_tga_read` of native/src/gip_codec.cpp), built here
from `native/src` and called through ctypes as `scripts/filter_image.py`
calls them: the same bytes written, the same pixels read.  The port writes
through the same functions in its own library; the numpy writers below are
their plain versions, which both are held to.
"""

import ctypes
import re
import struct

import numpy as np
import pytest

from gpu_image_processing_tpu_torch.utils import image_io, native_codec

from .test_torch_png_tier import reference_library


@pytest.fixture(scope="module")
def gip():
    lib = ctypes.CDLL(reference_library())
    for name in ("gip_ppm_write", "gip_bmp_write", "gip_tga_write"):
        getattr(lib, name).argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for name in ("gip_ppm_read", "gip_tga_read"):
        getattr(lib, name).argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
    lib.gip_free.argtypes = [ctypes.c_void_p]
    return lib


def _gip_write(lib, name: str, path, arr: np.ndarray) -> int:
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    return getattr(lib, name)(str(path).encode(),
                              arr.ctypes.data_as(ctypes.c_char_p), h, w, c)


def _gip_read(lib, name: str, path):
    buf = ctypes.c_void_p()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, name)(str(path).encode(), ctypes.byref(buf),
                            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        return None
    raw = ctypes.string_at(buf, h.value * w.value * c.value)
    lib.gip_free(buf)
    return np.frombuffer(raw, np.uint8).reshape(h.value, w.value, c.value)


def _hwc(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return arr[:, :, None] if arr.ndim == 2 else arr


def ppm_bytes(arr: np.ndarray) -> bytes:
    """`gip_ppm_write`: P5 for one channel, P6 for three, maxval 255."""
    arr = _hwc(arr)
    h, w, c = arr.shape
    if c not in (1, 3):
        raise ValueError(f"PPM/PGM takes 1 or 3 channels, not {c}")
    return f"P{5 if c == 1 else 6}\n{w} {h}\n255\n".encode() + arr.tobytes()


def bmp_bytes(arr: np.ndarray) -> bytes:
    """`gip_bmp_write`: 24-bit BGR rows, bottom-up, each padded to 4 bytes;
    grey is replicated and alpha dropped."""
    arr = _hwc(arr)
    h, w, c = arr.shape
    if c not in (1, 3, 4) or not h or not w:
        raise ValueError(f"BMP takes 1, 3 or 4 channels, not shape {arr.shape}")
    row = (w * 3 + 3) & ~3
    if 54 + row * h > 0xFFFFFFFF:
        raise ValueError(f"a {w}x{h} image is too large for a BMP")
    rgb = np.repeat(arr, 3, axis=2) if c == 1 else arr[:, :, :3]
    pixels = np.zeros((h, row), np.uint8)
    pixels[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<2sIIIIiiHHII16x", b"BM", 54 + row * h, 0, 54, 40,
                         w, h, 1, 24, 0, row * h)
    return header + pixels.tobytes()


def tga_bytes(arr: np.ndarray) -> bytes:
    """`gip_tga_write`: uncompressed, top-down; type 3 (grey) for one
    channel, else type 2 with BGR or BGRA pixels."""
    arr = _hwc(arr)
    h, w, c = arr.shape
    if c not in (1, 3, 4) or not 0 < w <= 0xFFFF or not 0 < h <= 0xFFFF:
        raise ValueError(f"TGA takes 1, 3 or 4 channels and sides up to "
                         f"65535, not shape {arr.shape}")
    header = bytearray(18)
    header[2] = 3 if c == 1 else 2
    header[12:16] = struct.pack("<HH", w, h)
    header[16] = 8 * c
    header[17] = 0x20 | (8 if c == 4 else 0)
    pixels = arr if c == 1 else arr[:, :, [2, 1, 0, 3][:c]]
    return bytes(header) + np.ascontiguousarray(pixels).tobytes()


WRITERS = {"ppm": ("gip_ppm_write", ppm_bytes, (1, 3)),
           "bmp": ("gip_bmp_write", bmp_bytes, (1, 3, 4)),
           "tga": ("gip_tga_write", tga_bytes, (1, 3, 4))}


@pytest.mark.parametrize("shape", [(5, 7), (1, 1), (1, 9), (8, 1), (13, 4)])
@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_writers_are_byte_equal_to_gip(rng, gip, tmp_path, fmt, shape):
    name, writer, channels = WRITERS[fmt]
    for c in (1, 2, 3, 4):
        arr = rng.integers(0, 256, (*shape, c), dtype=np.uint8)
        ref = tmp_path / f"ref_{c}.{fmt}"
        if c not in channels:
            assert _gip_write(gip, name, ref, arr) != 0
            with pytest.raises(ValueError):
                writer(arr)
            out = tmp_path / f"port_{c}.{fmt}"
            with pytest.raises(ValueError, match=re.escape(f"shape {arr.shape}")):
                image_io.save_image(str(out), arr)
            assert not out.exists()
            continue
        assert _gip_write(gip, name, ref, arr) == 0
        assert writer(arr) == ref.read_bytes(), (fmt, c)
        out = tmp_path / f"port_{c}.{fmt}"
        image_io.save_image(str(out), arr)
        assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("c", [1, 3])
def test_pgm_extension_writes_the_same_pnm(rng, gip, tmp_path, c):
    arr = rng.integers(0, 256, (6, 5, c), dtype=np.uint8)
    assert _gip_write(gip, "gip_ppm_write", tmp_path / "ref.pgm", arr) == 0
    image_io.save_image(str(tmp_path / "port.pgm"), arr)
    assert (tmp_path / "port.pgm").read_bytes() == (tmp_path / "ref.pgm").read_bytes()


@pytest.mark.parametrize("fmt,reader,c", [
    ("ppm", "gip_ppm_read", 1), ("ppm", "gip_ppm_read", 3),
    ("pgm", "gip_ppm_read", 1), ("pgm", "gip_ppm_read", 3),
    ("tga", "gip_tga_read", 1), ("tga", "gip_tga_read", 3),
    ("tga", "gip_tga_read", 4)])
def test_readers_equal_gip(rng, gip, tmp_path, fmt, reader, c):
    arr = rng.integers(0, 256, (9, 11, c), dtype=np.uint8)
    path = tmp_path / f"in.{fmt}"
    image_io.save_image(str(path), arr)
    want = _gip_read(gip, reader, path)
    np.testing.assert_array_equal(want, arr)
    got = image_io.load_image(str(path))
    # The CLI strips alpha, as the reference's does.
    np.testing.assert_array_equal(got, want[:, :, :3])


def test_ppm_reader_reads_comments_and_equals_gip(rng, gip, tmp_path):
    arr = rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n6 4\n# another\n255\n" + arr.tobytes())
    np.testing.assert_array_equal(_gip_read(gip, "gip_ppm_read", path), arr)
    np.testing.assert_array_equal(image_io.load_image(str(path)), arr)


def test_tga_reader_reads_rle_and_colour_maps_as_gip(gip, tmp_path):
    from .test_native_formats import _tga_colormapped_bytes
    rng = np.random.default_rng(3)
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    idx = rng.integers(0, 16, (5, 7)).astype(np.uint8)
    path = tmp_path / "map.tga"
    for rle in (False, True):
        path.write_bytes(_tga_colormapped_bytes(idx, palette, rle=rle))
        want = _gip_read(gip, "gip_tga_read", path)
        np.testing.assert_array_equal(want[:, :, :3], palette[idx])
        np.testing.assert_array_equal(image_io.load_image(str(path)),
                                      want[:, :, :3])


def test_other_formats_load_through_the_upload_decoders(rng, tmp_path):
    arr = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    path = tmp_path / "a.png"
    image_io.save_image(str(path), arr)
    np.testing.assert_array_equal(image_io.load_image(str(path)), arr)
    path = tmp_path / "a.bmp"
    image_io.save_image(str(path), arr)
    np.testing.assert_array_equal(image_io.load_image(str(path)), arr)
    grey = arr[:, :, :1]
    image_io.save_image(str(tmp_path / "g.png"), grey)
    np.testing.assert_array_equal(image_io.load_image(str(tmp_path / "g.png")), grey)


def test_jpeg_and_hdr_writers_use_the_native_codec(rng, tmp_path):
    arr = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    image_io.save_image(str(tmp_path / "a.jpg"), arr)
    assert (tmp_path / "a.jpg").read_bytes() == native_codec.jpeg_encode(arr, 90)
    image_io.save_image(str(tmp_path / "a.hdr"), arr)
    assert native_codec.hdr_write(str(tmp_path / "b.hdr"), arr)
    assert (tmp_path / "a.hdr").read_bytes() == (tmp_path / "b.hdr").read_bytes()
    with pytest.raises(RuntimeError, match="4-channel image as JPEG"):
        image_io.save_image(str(tmp_path / "a.jpeg"), np.dstack([arr, arr[..., :1]]))


@pytest.mark.parametrize("name", ["a.webp", "a.tiff", "noext"])
def test_other_extensions_raise(rng, tmp_path, name):
    with pytest.raises(ValueError, match="other formats need Pillow"):
        image_io.save_image(str(tmp_path / name), np.zeros((2, 2, 3), np.uint8))
    assert not (tmp_path / name).exists()


def test_load_frames_of_a_gif(tmp_path):
    from .test_native_formats import _gif_anim_bytes
    rng = np.random.default_rng(5)
    frames_in = [rng.integers(0, 4, (6, 8)).astype(np.uint8) for _ in range(3)]
    palette = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    path = tmp_path / "anim.gif"
    path.write_bytes(_gif_anim_bytes((6, 8), palette, [
        {"idx": f, "at": (0, 0), "delay_cs": 5, "dispose": 1,
         "transparent": None} for f in frames_in]))
    frames, delays, tier = image_io.load_frames(str(path))
    assert frames.shape == (3, 6, 8, 3) and tier == "native" and len(delays) == 3
    np.testing.assert_array_equal(frames[1], palette[frames_in[1]])
