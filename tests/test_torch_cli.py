"""The port's image-file CLI (tools/filter_image.py) against the JAX
package's `scripts/filter_image.py`, loaded with importlib and run on the
CPU with its native codec tier (built here from `native/src`) and Pillow
switched off, so that both write through the same codecs: the same files
out for every filter at levels 1 and 2 and for every output extension
(colour Sobel at level 2 within tests/sobel_tolerance.py), and the same
printed lines apart from the numbers.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import PIL
import PIL.Image  # noqa: F401  (kept loaded while PIL is switched off)
import pytest

from gpu_image_processing_tpu.utils import image as jax_image
from gpu_image_processing_tpu.utils import native_codec as jax_native_codec
from gpu_image_processing_tpu_torch.tools import filter_image
from gpu_image_processing_tpu_torch.utils import image_io, native_codec

from .sobel_tolerance import assert_sobel_close
from .test_torch_png_tier import reference_library

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_filter_image", ROOT / "scripts" / "filter_image.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native codec, and no Pillow for its CLI."""
    monkeypatch.setenv("GIP_NATIVE_LIB", reference_library())
    monkeypatch.setattr(jax_native_codec, "_LIB", None)
    monkeypatch.setattr(jax_native_codec, "_SEARCHED", False)
    monkeypatch.setattr(jax_image, "PIL_AVAILABLE", False)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert jax_native_codec.available()


def _image(seed: int = 7, h: int = 21, w: int = 26, c: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 9 + y * 5 + 60 * k) % 256 for k in range(c)], -1)
    return np.clip(base + rng.integers(0, 40, (h, w, c)), 0, 255).astype(np.uint8)


def _numbers_out(text: str) -> list[str]:
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)
            for line in text.strip().splitlines()]


def _run_both(jax_cli, capsys, monkeypatch, tmp_path, src: str, args: list[str]):
    """Run both CLIs from their own directory on a copy of `src` with the
    same arguments; (port dir, jax dir, port stdout, jax stdout)."""
    outs = {}
    for name in ("port", "jax"):
        work = tmp_path / name
        work.mkdir()
        (work / Path(src).name).write_bytes(Path(src).read_bytes())
        monkeypatch.chdir(work)
        if name == "port":
            rc = filter_image.main([*args, "--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["filter_image.py", *args])
            rc = jax_cli.main()
        assert rc == 0
        outs[name] = (work, capsys.readouterr().out)
    return outs["port"][0], outs["jax"][0], outs["port"][1], outs["jax"][1]


def _source(tmp_path, img: np.ndarray, name: str = "in.ppm") -> str:
    path = tmp_path / name
    image_io.save_image(str(path), img)
    return str(path)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("filt", ["gaussian", "box", "sobel"])
def test_each_filter_writes_what_the_jax_cli_writes(jax_cli, jax_native, capsys,
                                                    monkeypatch, tmp_path, filt,
                                                    level):
    src = _source(tmp_path, _image())
    port, jax, port_out, jax_out = _run_both(
        jax_cli, capsys, monkeypatch, tmp_path, src,
        ["in.ppm", "--filter", filt, "--level", str(level), "--radius", "2"])
    name = f"in_{filt}_l{level}.png"   # the default output name
    got = native_codec.png_decode((port / name).read_bytes())
    want = native_codec.png_decode((jax / name).read_bytes())
    if filt == "sobel" and level == 2:
        assert_sobel_close(got, want)
    else:
        assert (port / name).read_bytes() == (jax / name).read_bytes()
    assert _numbers_out(port_out) == _numbers_out(jax_out)
    assert port_out.splitlines()[-1] == f"Saved: {name}"


@pytest.mark.parametrize("ext", [".png", ".ppm", ".pgm", ".bmp", ".tga",
                                 ".hdr", ".jpg"])
def test_each_output_extension_matches_the_jax_cli(jax_cli, jax_native, capsys,
                                                   monkeypatch, tmp_path, ext):
    src = _source(tmp_path, _image(c=1) if ext == ".pgm" else _image())
    out = "out" + ext
    port, jax, port_out, jax_out = _run_both(
        jax_cli, capsys, monkeypatch, tmp_path, src,
        ["in.ppm", out, "--filter", "gaussian", "--level", "2"])
    assert (port / out).read_bytes() == (jax / out).read_bytes()
    assert _numbers_out(port_out) == _numbers_out(jax_out)


def test_png_input_and_grey(jax_cli, jax_native, capsys, monkeypatch, tmp_path):
    """A grey PNG input stays one channel, as both loaders keep it."""
    src = _source(tmp_path, _image(c=1), "grey.png")
    monkeypatch.setitem(sys.modules, "PIL", PIL)   # the JAX CLI opens PNG with Pillow
    port, jax, port_out, jax_out = _run_both(
        jax_cli, capsys, monkeypatch, tmp_path, src,
        ["grey.png", "g.tga", "--filter", "box", "--level", "1"])
    assert (port / "g.tga").read_bytes() == (jax / "g.tga").read_bytes()
    assert "1 channel(s)" in port_out
    assert _numbers_out(port_out) == _numbers_out(jax_out)


def test_load_16_matches_the_jax_cli(jax_cli, jax_native, capsys, monkeypatch,
                                     tmp_path):
    from .test_native_formats import _png_bytes
    wide = np.random.default_rng(3).integers(0, 1 << 16, (14, 17, 3))
    (tmp_path / "wide.png").write_bytes(_png_bytes(wide, 16, 2))
    port, jax, port_out, jax_out = _run_both(
        jax_cli, capsys, monkeypatch, tmp_path, str(tmp_path / "wide.png"),
        ["wide.png", "w.png", "--load", "16", "--filter", "gaussian"])
    assert (port / "w.png").read_bytes() == (jax / "w.png").read_bytes()
    assert _numbers_out(port_out) == _numbers_out(jax_out)
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]   # the u16 range


def test_frames_matches_the_jax_cli(jax_cli, jax_native, capsys, monkeypatch,
                                    tmp_path):
    from .test_native_formats import _gif_anim_bytes
    rng = np.random.default_rng(9)
    palette = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    frames = [rng.integers(0, 4, (10, 12)).astype(np.uint8) for _ in range(3)]
    (tmp_path / "anim.gif").write_bytes(_gif_anim_bytes((10, 12), palette, [
        {"idx": f, "at": (0, 0), "delay_cs": 4 + i, "dispose": 1,
         "transparent": None} for i, f in enumerate(frames)]))
    port, jax, port_out, jax_out = _run_both(
        jax_cli, capsys, monkeypatch, tmp_path, str(tmp_path / "anim.gif"),
        ["anim.gif", "--frames", "--filter", "sobel", "--level", "1"])
    for i in range(3):
        name = f"anim_sobel_l1_f{i:03d}.png"
        assert (port / name).read_bytes() == (jax / name).read_bytes()
    assert _numbers_out(port_out) == _numbers_out(jax_out)
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]   # the delays


@pytest.mark.parametrize("args,message", [
    (["--sigma", "50"], "Error: sigma must be in [0.5, 20.0]"),
    (["--radius", "0"], "Error: radius must be in [1, 15]"),
])
def test_refusals_print_what_the_jax_cli_prints(jax_cli, capsys, monkeypatch,
                                               tmp_path, args, message):
    monkeypatch.setattr(sys, "argv", ["filter_image.py", "x.png", *args])
    assert jax_cli.main() == 1
    assert capsys.readouterr().out.strip() == message
    assert filter_image.main(["x.png", *args, "--device", "cpu"]) == 1
    assert capsys.readouterr().out.strip() == message


def test_the_cli_asks_for_cuda_unless_told_otherwise(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    src = _source(tmp_path, _image())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        filter_image.main([src])
