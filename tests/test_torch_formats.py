"""The port's upload codec (utils/image.py, utils/native_codec.py) against the
JAX package's, on the same bytes: every format and PNG variant the JAX
package serves.

Two references, both the JAX package's own code, unedited:

* its Pillow tier (`jax_pil`: Pillow present, no native library), which
  is what it serves on a host with Pillow; every PNG variant is held to it
  exactly, and JPEG to within 3 at 4:4:4 and 4:2:0 and within 4 at 4:2:2
  (Pillow's IDCT and chroma upsampling against the native ones);
* its native tier (`jax_native`: Pillow switched off, `GIP_NATIVE_LIB`
  naming a library built here from the same `native/src`), which is what
  it serves without Pillow; JPEG and every other native format are held
  to it exactly.

The format builders come from tests/test_native_formats.py.  Tests that
need a decoder library skip only where no C++ compiler exists.
"""

import base64
import io
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gpu_image_processing_tpu.utils import image as jax_image
from gpu_image_processing_tpu.utils import native_codec as jax_native_codec
from gpu_image_processing_tpu_torch.core.files import ROOT_DIR
from gpu_image_processing_tpu_torch.ops.cuda import build
from gpu_image_processing_tpu_torch.utils import image as codec
from gpu_image_processing_tpu_torch.utils import native_codec

from .test_native_formats import (
    _bmp_bytes,
    _gif_anim_bytes,
    _gif_bytes,
    _hdr_bytes,
    _pic_bytes_rle,
    _pic_bytes_uncompressed,
    _png_bytes,
    _psd_bytes,
    _safe_rgbe,
    _tga_colormapped_bytes,
)

FIXTURES = Path(__file__).parent / "data" / "torch_formats"

# The reference sources of the JAX package's native tier.
NATIVE_SRC = ROOT_DIR / "native" / "src"


def _cxx() -> str:
    try:
        return build.cxx_path()
    except RuntimeError:
        pytest.skip("no C++ compiler: the decoder library cannot be built")


@pytest.fixture(scope="module")
def decoders():
    """The port's decoder library, built here at first use."""
    _cxx()
    return native_codec.load()


@pytest.fixture(scope="module")
def reference_lib(tmp_path_factory):
    """The JAX package's native library (codec, decoders, JPEG), built from
    native/src as its CMake build would."""
    src = NATIVE_SRC
    out = tmp_path_factory.mktemp("gip_native") / "libgip_codec.so"
    proc = subprocess.run(
        [_cxx(), "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(out),
         str(src / "gip_codec.cpp"), str(src / "gip_formats.cpp"),
         str(src / "gip_jpeg.cpp"), "-lz"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return str(out)


@pytest.fixture
def jax_pil(monkeypatch):
    """The JAX package's codec with Pillow and without its native library."""
    monkeypatch.setattr(jax_native_codec, "_LIB", None)
    monkeypatch.setattr(jax_native_codec, "_SEARCHED", True)
    monkeypatch.setattr(jax_image, "PIL_AVAILABLE", True)
    return jax_image


@pytest.fixture
def jax_native(monkeypatch, reference_lib, decoders):
    """The JAX package's codec without Pillow: its native tier."""
    monkeypatch.setenv("GIP_NATIVE_LIB", reference_lib)
    monkeypatch.setattr(jax_native_codec, "_LIB", None)
    monkeypatch.setattr(jax_native_codec, "_SEARCHED", False)
    monkeypatch.setattr(jax_image, "PIL_AVAILABLE", False)
    assert jax_native_codec.available()
    return jax_image


def _native_served(request, data: bytes) -> np.ndarray:
    """What the JAX package serves for a base64 upload of `data` through its
    native tier, which it tries first, whatever tier the test has set."""
    reference_lib = request.getfixturevalue("reference_lib")
    with pytest.MonkeyPatch.context() as m:
        m.setenv("GIP_NATIVE_LIB", reference_lib)
        m.setattr(jax_native_codec, "_LIB", None)
        m.setattr(jax_native_codec, "_SEARCHED", False)
        m.setattr(jax_image, "PIL_AVAILABLE", False)
        assert jax_native_codec.available()
        return jax_image.decode_base64_image(_b64(data))


def _b64(data: bytes, mime: str = "image/png") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


def _pil_bytes(arr, fmt, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kwargs)
    return buf.getvalue()


def _photo(rng, h=241, w=317, c=3) -> np.ndarray:
    """Smooth content with edges and mild noise, as a photo has."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / 23 + k) * np.cos(y / 31 - k)
                     for k in range(c)], axis=-1)
    base[h // 3:2 * h // 3, w // 4:w // 2] = 40   # a hard-edged block
    noise = rng.normal(0, 6, size=(h, w, c))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _same(port, jax, data: bytes, served=None) -> np.ndarray:
    """Both codecs' base64 decode and upload decode of `data` agree; with
    `served`, the port's base64 decode equals it instead (where the JAX
    package's native PNG tier, which it tries first, reduces otherwise than
    its Pillow tier)."""
    got = port.decode_base64_image(_b64(data))
    want = jax.decode_base64_image(_b64(data)) if served is None else served
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    got_file, want_file = port.load_image_file(data), jax.load_image_file(data)
    assert got_file[1:] == want_file[1:]
    np.testing.assert_array_equal(got_file[0], want_file[0])
    return got


# -- PNG: every variant, against the Pillow tier ----------------------------

PNG_VARIANTS = ([(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)]
                + [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16)]
                + [(6, 8), (6, 16)])


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("colour,depth", PNG_VARIANTS)
def test_png_variant_matches_jax(request, rng, jax_pil, colour, depth,
                                 interlace):
    h, w = 13, 17
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    values = rng.integers(0, 1 << depth, (h, w, samples))
    palette = None
    if colour == 3:
        palette = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
    data = _png_bytes(values, depth, colour, interlace, palette=palette)
    served = None
    if (colour, depth) == (0, 16):   # the tiers reduce 16-bit grey otherwise
        served = _native_served(request, data)
    got = _same(codec, jax_pil, data, served)
    assert got.shape == (h, w, 3)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette_with_trns_matches_jax(rng, jax_pil, depth):
    n = 1 << depth
    palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    idx = rng.integers(0, n, (9, 14))
    data = _png_bytes(idx, depth, 3, palette=palette,
                      trns=list(rng.integers(0, 256, max(1, n // 2))))
    np.testing.assert_array_equal(_same(codec, jax_pil, data), palette[idx])


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (7, 5), (8, 9), (16, 16)])
def test_png_adam7_small_images(rng, jax_pil, hw):
    """Small images leave some Adam7 passes empty."""
    a = rng.integers(0, 256, (*hw, 3))
    np.testing.assert_array_equal(
        _same(codec, jax_pil, _png_bytes(a, 8, 2, interlace=1)), a)


def test_png_16bit_grey_rescales_by_its_maximum(request, jax_pil):
    """The upload endpoint's loader rescales 16-bit grey by its maximum, as
    the JAX package's Pillow tier does; a base64 upload keeps the high
    byte, as its native PNG tier, tried first, does."""
    values = np.array([[0, 1000, 2000], [3000, 4000, 5000]])
    data = _png_bytes(values, 16, 0)
    _same(codec, jax_pil, data,
          served=_native_served(request, data))
    want = (values.astype(np.float32) * np.float32(255 / 5000)).astype(np.uint8)
    np.testing.assert_array_equal(codec.load_image_file(data)[0][..., 0], want)


@pytest.mark.parametrize("colour,depth,channels", [
    (0, 1, 3), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 3), (3, 4, 3), (4, 8, 3)])
def test_png_upload_keeps_grey_where_pillow_does(request, rng, jax_pil, colour,
                                                  depth, channels):
    samples = 2 if colour == 4 else 1
    values = rng.integers(0, 1 << depth, (5, 6, samples))
    palette = rng.integers(0, 256, (16, 3)).astype(np.uint8) if colour == 3 else None
    data = _png_bytes(values, depth, colour, palette=palette)
    arr, w, h = codec.load_image_file(data)
    assert (h, w, arr.shape[2]) == (5, 6, channels)
    served = None
    if (colour, depth) == (0, 16):   # the tiers reduce 16-bit grey otherwise
        served = _native_served(request, data)
    _same(codec, jax_pil, data, served)


@pytest.mark.parametrize("colour,depth", PNG_VARIANTS)
def test_png_decode_file_16_matches_jax(rng, jax_native, colour, depth):
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    values = rng.integers(0, 1 << depth, (7, 9, samples))
    kwargs = {}
    if colour == 3:
        kwargs = {"palette": rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8),
                  "trns": [7, 200]}
    data = _png_bytes(values, depth, colour, interlace=depth % 2, **kwargs)
    got, want = codec.decode_file_16(data), jax_native.decode_file_16(data)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


# -- JPEG ------------------------------------------------------------------


#: The native decoder against Pillow's (libjpeg), by subsampling: at 4:2:2
#: (horizontal chroma upsampling) a few samples of hard edges differ by 4
#: (1 or 2 of 229,131 values on this content), else at most 3.
PILLOW_MAX_DIFF = {0: 3, 1: 4, 2: 3}


@pytest.mark.parametrize("subsampling", [0, 1, 2])   # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize("quality", [75, 90, 95])
def test_jpeg_equals_the_native_tier_and_stays_near_pillow(
        rng, jax_native, subsampling, quality):
    data = _pil_bytes(_photo(rng), "JPEG", quality=quality,
                      subsampling=subsampling)
    got = _same(codec, jax_native, data)
    pillow = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    diff = np.abs(got.astype(int) - pillow)
    assert diff.max() <= PILLOW_MAX_DIFF[subsampling]
    assert (diff > 3).sum() <= 2


def test_grey_jpeg_equals_the_native_tier(rng, jax_native):
    data = _pil_bytes(_photo(rng, c=1)[..., 0], "JPEG", quality=90)
    got = codec.decode_base64_image(_b64(data))
    np.testing.assert_array_equal(got, jax_native.decode_base64_image(_b64(data)))
    pillow = np.array(Image.open(io.BytesIO(data)))
    assert np.abs(got[..., 0].astype(int) - pillow).max() <= 3
    arr, _, _ = codec.load_image_file(data)   # grey stays one channel
    np.testing.assert_array_equal(arr, got[..., :1])


def test_jpeg_within_3_of_the_pillow_tier(rng, jax_pil, decoders):
    data = _pil_bytes(_photo(rng), "JPEG", quality=90)
    got = codec.decode_base64_image(_b64(data))
    want = jax_pil.decode_base64_image(_b64(data))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 3


def test_jpeg_passthrough_rules(rng, decoders):
    img = _photo(rng, 40, 56)
    neutral = _pil_bytes(img, "JPEG", quality=90)
    arr, passthrough = codec.decode_base64_image_ex(_b64(neutral, "image/jpeg"))
    assert passthrough == _b64(neutral, "image/jpeg")
    # EXIF (orientation may rotate the display) and grey (normalized to
    # RGB) lose the passthrough, and so does a cut or padded stream.
    exif = _pil_bytes(img, "JPEG", quality=90, exif=b"Exif\x00\x00II*\x00")
    assert codec.decode_base64_image_ex(_b64(exif))[1] is None
    grey = _pil_bytes(img[..., 0], "JPEG")
    assert codec.decode_base64_image_ex(_b64(grey))[1] is None
    for cut in (neutral[:-2], neutral + b"\x00"):
        assert not codec._jpeg_headers_neutral(cut)
    # A progressive JPEG decodes, but its SOF2 is not passed through.
    progressive = _pil_bytes(img, "JPEG", quality=90, progressive=True)
    got, passthrough = codec.decode_base64_image_ex(_b64(progressive))
    assert passthrough is None and got.shape == arr.shape
    np.testing.assert_array_equal(arr, codec.decode_base64_image(_b64(exif)))


def test_jpeg_encode_matches_jax_binding(rng, jax_native):
    img = _photo(rng, 33, 47)
    data = native_codec.jpeg_encode(img, 90)
    assert data == jax_native_codec.jpeg_encode(img, 90)
    np.testing.assert_array_equal(native_codec.jpeg_decode(data),
                                  jax_native_codec.jpeg_decode(data))
    assert native_codec.jpeg_encode(np.zeros((4, 4, 2), np.uint8)) is None


# -- the other native formats ------------------------------------------------


def _native_cases(rng):
    arr = rng.integers(0, 255, size=(23, 31, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, size=(6, 5, 4), dtype=np.uint8)
    grey = rng.integers(0, 256, size=(9, 11), dtype=np.uint8)
    pal = [(i * 3 % 256, i * 5 % 256, i * 7 % 256) for i in range(8)]
    idx = rng.integers(0, 8, size=(6, 9), dtype=np.uint8)
    p_img = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=150)
    buf = io.BytesIO()
    p_img.save(buf, format="GIF")
    gif = buf.getvalue()
    buf = io.BytesIO()
    p_img.save(buf, format="BMP")
    bmp8 = buf.getvalue()
    px16 = rng.integers(0, 1 << 16, size=(7, 11), dtype=np.uint16)
    rows32 = [rgba[y][:, [2, 1, 0, 3]].tobytes() for y in range(6)]
    return {
        "gif": gif,
        "gif interlaced": _gif_bytes(idx, pal, interlace=True),
        "gif transparent": _gif_bytes(idx, pal, transparent=2),
        "bmp 24": _pil_bytes(arr, "BMP"),
        "bmp 8 palette": bmp8,
        "bmp 16 bitfields": _bmp_bytes(
            11, 7, 16, [px16[y].astype("<u2").tobytes() for y in range(7)],
            compression=3, masks=struct.pack("<III", 0xF800, 0x07E0, 0x001F)),
        "bmp 32 top-down": _bmp_bytes(5, 6, 32, rows32, top_down=True),
        "psd raw": _psd_bytes(arr),
        "psd rle": _psd_bytes(arr, compression=1),
        "psd grey": _psd_bytes(grey),
        "psd 16": _psd_bytes(arr, depth=16),
        "hdr": _hdr_bytes(_safe_rgbe(rng, 4, 9)),
        "hdr rle": _hdr_bytes(_safe_rgbe(rng, 5, 12), new_rle=True),
        "pic": _pic_bytes_uncompressed(arr[:5, :7]),
        "pic rle rgba": _pic_bytes_rle(rgba),
        "pnm p6": _pil_bytes(arr, "PPM"),
        "pnm p5": _pil_bytes(grey, "PPM"),
        "pnm p5 16": b"P5 4 3 65535\n" + px16[:3, :4].astype(">u2").tobytes(),
        "tga rle": _pil_bytes(arr, "TGA", compression="tga_rle"),
        "tga rgba": _pil_bytes(rgba, "TGA"),
        "tga grey": _pil_bytes(grey, "TGA"),
        "tga colour-mapped": _tga_colormapped_bytes(idx, pal, rle=True),
    }


NATIVE_CASES = [
    "gif", "gif interlaced", "gif transparent", "bmp 24", "bmp 8 palette",
    "bmp 16 bitfields", "bmp 32 top-down", "psd raw", "psd rle", "psd grey",
    "psd 16", "hdr", "hdr rle", "pic", "pic rle rgba", "pnm p6", "pnm p5",
    "pnm p5 16", "tga rle", "tga rgba", "tga grey", "tga colour-mapped"]
#: Cases the JAX package's Pillow tier reads to the same pixels as its
#: native tier (tests/test_native_formats.py holds those two together).
PILLOW_AGREES = {"gif", "bmp 24", "bmp 8 palette", "psd raw", "psd rle",
                 "psd grey", "pnm p6", "pnm p5", "tga rle", "tga rgba",
                 "tga grey"}


@pytest.mark.parametrize("case", NATIVE_CASES)
def test_native_format_matches_jax(case, jax_native, monkeypatch):
    """The base64 decode equals the native tier's; so does the upload
    decode, except that the native tier makes grey RGB where the Pillow
    tier (and the port) keep one channel."""
    cases = _native_cases(np.random.default_rng(0))
    assert sorted(cases) == sorted(NATIVE_CASES)
    data = cases[case]
    got = codec.decode_base64_image(_b64(data))
    assert got.shape[2] == 3
    np.testing.assert_array_equal(got, jax_native.decode_base64_image(_b64(data)))
    upload, w, h = codec.load_image_file(data)
    want, want_w, want_h = jax_native.load_image_file(data)
    assert (w, h) == (want_w, want_h) and upload.shape[2] in (1, 3)
    np.testing.assert_array_equal(codec._normalize_rgb(upload), want)
    if case in PILLOW_AGREES:
        monkeypatch.setattr(jax_native_codec, "_SEARCHED", True)
        monkeypatch.setattr(jax_native_codec, "_LIB", None)
        monkeypatch.setattr(jax_image, "PIL_AVAILABLE", True)
        np.testing.assert_array_equal(_same(codec, jax_image, data), got)


@pytest.mark.parametrize("case", ["psd raw", "psd 16", "hdr", "gif",
                                  "tga rle", "pnm p6"])
def test_decode_file_16_and_float_match_jax(case, jax_native):
    """PSD and HDR at their own depth, the rest through the upload decode
    (RGB here: the native tier makes grey RGB, see above)."""
    data = _native_cases(np.random.default_rng(0))[case]
    np.testing.assert_array_equal(codec.decode_file_16(data),
                                  jax_native.decode_file_16(data))
    got, want = codec.decode_file_float(data), jax_native.decode_file_float(data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_file_float_of_a_png_matches_jax(rng, jax_native):
    data = _png_bytes(rng.integers(0, 256, (4, 6, 3)), 8, 2)
    np.testing.assert_array_equal(codec.decode_file_float(data),
                                  jax_native.decode_file_float(data))


def test_gif_frames_and_hdr_write_match_jax(rng, jax_native, tmp_path):
    pal = [(0, 0, 0), (255, 0, 0), (0, 255, 0), (0, 0, 255)]
    frames = [{"idx": rng.integers(0, 4, (4, 5)), "delay_cs": 5, "dispose": 2},
              {"idx": rng.integers(0, 4, (2, 3)), "at": (1, 1), "delay_cs": 7,
               "dispose": 1, "transparent": 0}]
    data = _gif_anim_bytes((6, 7), pal, frames)
    (got, delays), (want, want_delays) = (native_codec.gif_frames(data),
                                          jax_native_codec.gif_frames(data))
    np.testing.assert_array_equal(got, want)
    assert delays == want_delays == [50, 70]
    assert native_codec.gif_frames(b"GIF89a" + bytes(8)) is None
    img = rng.integers(0, 256, (5, 8, 3), dtype=np.uint8)
    assert native_codec.hdr_write(str(tmp_path / "port.hdr"), img)
    assert jax_native_codec.hdr_write(str(tmp_path / "jax.hdr"), img)
    assert (tmp_path / "port.hdr").read_bytes() == (tmp_path / "jax.hdr").read_bytes()


# -- refusals, sniffing, tiers -------------------------------------------------


def _truncated_cases():
    rng = np.random.default_rng(1)
    cases = _native_cases(rng)
    jpeg = _pil_bytes(_photo(rng, 24, 32), "JPEG")
    return {
        "jpeg": jpeg[:len(jpeg) // 2],
        "gif": cases["gif"][:40],
        "bmp": cases["bmp 24"][:60],
        "psd": cases["psd raw"][:50],
        "hdr": cases["hdr"][:-20],
        "pic": cases["pic"][:110],
        "pnm": cases["pnm p6"][:-7],
        "tga": cases["tga rle"][:30],
        "png": _png_bytes(rng.integers(0, 256, (4, 4, 3)), 8, 2)[:60],
    }


@pytest.mark.parametrize("case", ["jpeg", "gif", "bmp", "psd", "hdr", "pic",
                                  "pnm", "tga", "png"])
def test_truncated_files_are_refused(case, decoders):
    data = _truncated_cases()[case]
    before = codec.decode_tier_counts()["failed"]
    with pytest.raises(codec.ImageCodecError, match="Failed to decode image"):
        codec.decode_base64_image(_b64(data))
    assert codec.decode_tier_counts()["failed"] == before + 1
    with pytest.raises(codec.ImageCodecError):
        codec.load_image_file(data)


@pytest.mark.parametrize("data", [b"hello world, this is not an image",
                                  b'{"json": true, "x": 12345678}',
                                  bytes(64), b"\x89PNX" + bytes(40)])
def test_unknown_bytes_are_refused_and_tga_sniff_rejects_text(data, decoders):
    assert codec._sniff_native_fallback(data) == (None, None)
    with pytest.raises(codec.ImageCodecError, match="unrecognised image format"):
        codec.decode_base64_image(_b64(data))


def test_tga_sniff_is_tried_last():
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 2, 1, 24, 0x20)
    assert codec._tga_plausible(hdr)
    assert codec._sniff_native_fallback(hdr)[1] == "native_tga"
    assert codec._sniff_native_fallback(b"BM" + hdr[2:])[1] == "native_bmp"
    assert not codec._tga_plausible(hdr[:17])


@pytest.mark.parametrize("case,tier", [
    ("gif", "native_gif"), ("bmp 24", "native_bmp"), ("psd raw", "native_psd"),
    ("hdr", "native_hdr"), ("pic", "native_pic"), ("pnm p6", "native_pnm"),
    ("tga rle", "native_tga")])
def test_each_upload_counts_its_tier(case, tier, decoders):
    data = _native_cases(np.random.default_rng(0))[case]
    before = codec.decode_tier_counts()
    codec.decode_base64_image(_b64(data))
    after = codec.decode_tier_counts()
    assert {k for k in after if after[k] != before[k]} == {tier}
    assert after[tier] == before[tier] + 1


def test_tier_keys_are_the_jax_native_keys_and_zlib_png(rng):
    jax_keys = set(jax_image.decode_tier_counts())
    assert set(codec.DECODE_TIERS) == (jax_keys - {"pil"}) | {"zlib_png"}
    before = codec.decode_tier_counts()
    codec.decode_base64_image(_b64(_png_bytes(rng.integers(0, 256, (3, 3, 3)), 8, 2)))
    after = codec.decode_tier_counts()
    assert after["native_png"] == before["native_png"] + 1
    assert after["zlib_png"] == before["zlib_png"]
    # A tRNS longer than the palette: the native tier refuses it (as
    # gip_png_decode does), the zlib tier reads it.
    palette = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    data = _png_bytes(rng.integers(0, 4, (3, 5)), 8, 3, palette=palette,
                      trns=[1, 2, 3, 4, 5])
    assert codec.native_codec.png_decode(data) is None
    np.testing.assert_array_equal(codec.decode_base64_image(_b64(data)),
                                  codec.decode_png(data)[..., :3])
    last = codec.decode_tier_counts()
    assert last["zlib_png"] == after["zlib_png"] + 1
    assert last["native_png"] == after["native_png"]


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "cxx_path", lambda: "false")
    with pytest.raises(RuntimeError, match="failed to build gip_decoders"):
        native_codec.load()


# -- the committed fixture set ---------------------------------------------------


def test_fixture_set_matches_expected(decoders):
    """The fixtures chip_smoke.py decodes on the card, against the pixels the
    JAX package gave for them (its native tier for JPEG)."""
    expected = np.load(FIXTURES / "expected.npz")
    files = sorted(p for p in FIXTURES.iterdir() if p.name != "expected.npz"
                   and p.suffix != ".py")
    assert sorted(expected.files) == [p.name for p in files]
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 100_000
    for path in files:
        got = codec.decode_base64_image(_b64(path.read_bytes()))
        np.testing.assert_array_equal(got, expected[path.name], err_msg=path.name)
