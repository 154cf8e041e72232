"""The image-file writers and readers of utils/image_io.py against the JAX
package's native ones (`gip_ppm_write`, `gip_bmp_write`, `gip_tga_write`,
`gip_ppm_read`, `gip_tga_read` of native/src/gip_codec.cpp), built here
from `native/src` and called through ctypes as `scripts/filter_image.py`
calls them: the same bytes written, the same pixels read.
"""

import ctypes

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


WRITERS = {"ppm": ("gip_ppm_write", image_io.ppm_bytes, (1, 3)),
           "bmp": ("gip_bmp_write", image_io.bmp_bytes, (1, 3, 4)),
           "tga": ("gip_tga_write", image_io.tga_bytes, (1, 3, 4))}


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
