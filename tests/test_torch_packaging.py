"""The port run from an installed wheel, offline, on the CPU.

The wheel is built (`pip wheel --no-deps --no-build-isolation --no-index`)
from a copy of the packaging inputs in a temporary directory, so that no
`build/` or `*.egg-info` lands in the repository, installed with `--target`
(`--no-deps --no-index`) and made read-only.  Every installed run starts in
a directory outside the checkout with `PYTHONPATH` at the install and
`XDG_CACHE_HOME` in the temporary directory, and may write nothing under the
install.
"""

import base64
import json
import os
import shutil
import socket
import stat
import subprocess
import sys
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest

from gpu_image_processing_tpu_torch.core.files import CARRIED
from gpu_image_processing_tpu_torch.utils.image import decode_png

ROOT = Path(__file__).resolve().parents[1]
JPEG = ROOT / "tests" / "data" / "torch_formats" / "jpeg_420.jpg"
PACKAGES = ("gpu_image_processing_tpu", "gpu_image_processing_tpu_torch")
#: Bounds, in seconds, on one step: the wheel's build, the install, one
#: run of an entry point (imports, and the codec library's build into the
#: cache), the server's start.
BUILD_TIMEOUT_S = 120
RUN_TIMEOUT_S = 120
HEALTH_TIMEOUT_S = 60
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _files(root: Path) -> dict[str, tuple[int, int]]:
    """Each file under `root`: (size, modification time in ns)."""
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in root.rglob("*") if p.is_file()}


def _set_writable(root: Path, writable: bool) -> None:
    for path in [root, *root.rglob("*")]:
        mode = path.stat().st_mode
        path.chmod(mode | stat.S_IWUSR if writable
                   else mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))


class Installed:
    """The wheel, its install and the environment of an installed run."""

    def __init__(self, base: Path):
        src, dist = base / "src", base / "dist"
        self.target, self.work, self.cache = (base / "install", base / "work",
                                              base / "cache")
        for name in (*PACKAGES, "pyproject.toml", "setup.py"):
            copy = shutil.copytree if (ROOT / name).is_dir() else shutil.copy
            copy(ROOT / name, src / name, **(
                {"ignore": shutil.ignore_patterns("_build", "__pycache__")}
                if copy is shutil.copytree else {}))
        for relative in CARRIED:
            (src / relative).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(ROOT / relative, src / relative)
        self._pip("wheel", "--no-deps", "--no-build-isolation", "--no-index",
                  "-w", str(dist), str(src))
        (self.wheel,) = dist.glob("*.whl")
        self._pip("install", "--no-deps", "--no-index", "--target",
                  str(self.target), str(self.wheel))
        _set_writable(self.target, False)
        self.work.mkdir()
        self.snapshot = _files(self.target)
        self.env = {**os.environ, "PYTHONPATH": str(self.target),
                    "XDG_CACHE_HOME": str(self.cache)}

    @staticmethod
    def _pip(*args: str) -> None:
        proc = subprocess.run([sys.executable, "-m", "pip", *args],
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def run(self, *args: str) -> subprocess.CompletedProcess:
        """`python -m gpu_image_processing_tpu_torch.<args>` from the work
        directory; nothing may be written under the install."""
        proc = subprocess.run(
            [sys.executable, "-m", f"gpu_image_processing_tpu_torch.{args[0]}",
             *args[1:]], cwd=self.work, env=self.env, capture_output=True,
            text=True, timeout=RUN_TIMEOUT_S)
        assert _files(self.target) == self.snapshot
        return proc


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    inst = Installed(tmp_path_factory.mktemp("packaging"))
    yield inst
    _set_writable(inst.target, True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_wheel_carries_the_native_sources(installed):
    names = zipfile.ZipFile(installed.wheel).namelist()
    assert "native/src/gip_codec.cpp" in CARRIED
    for relative in CARRIED:
        assert f"gpu_image_processing_tpu_torch/_carried/{relative}" in names
    for kernel in ("blur.cu", "sobel.cu", "launch.cuh", "edges.cuh"):
        assert f"gpu_image_processing_tpu_torch/ops/cuda/{kernel}" in names
    # Neither the tests nor the web UI: the checkout's.
    assert not [n for n in names if n.startswith(("tests/", "frontend/"))]
    assert not [n for n in names if "/_build/" in n]


def test_the_installed_cli_writes_the_checkouts_pixels(installed, tmp_path):
    ours = installed.work / "jpeg_gaussian.png"
    proc = installed.run("tools.filter_image", str(JPEG), str(ours),
                         "--filter", "gaussian", "--level", "2",
                         "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    theirs = tmp_path / "jpeg_gaussian.png"
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools."
         "filter_image", str(JPEG), str(theirs), "--filter", "gaussian",
         "--level", "2", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_array_equal(decode_png(ours.read_bytes()),
                                  decode_png(theirs.read_bytes()))
    # The codec's library was built into the cache, from the install's own
    # sources, under the names a checkout gives them.
    built = sorted(p.name.split("-")[0]
                   for p in (installed.cache /
                             "gpu_image_processing_tpu_torch").iterdir())
    assert built == ["gip_decoders"]
    checkout = ROOT / "gpu_image_processing_tpu_torch" / "ops" / "cuda" / "_build"
    for lib in (installed.cache / "gpu_image_processing_tpu_torch").iterdir():
        assert (checkout / lib.name).exists(), lib.name


def test_the_installed_server_answers_process_all(installed):
    port = _free_port()
    opts = ["--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
            "--run-dir", str(installed.work / "run"), "--timeout",
            str(HEALTH_TIMEOUT_S)]
    started = installed.run("tools.serve", "start", "--no-frontend", *opts)
    try:
        assert started.returncode == 0, started.stdout + started.stderr
        body = json.dumps({
            "image": base64.b64encode(JPEG.read_bytes()).decode(),
            "filter": "gaussian", "sigma": 2.0, "radius": 3}).encode()
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/process-all", data=body,
            headers={"Content-Type": "application/json"})
        with OPENER.open(request, timeout=RUN_TIMEOUT_S) as resp:
            answer = json.loads(resp.read())
        levels = [answer["results"][f"level_{lv}"] for lv in (1, 2)]
        images = [decode_png(base64.b64decode(
            lv["processed_image"].split(",")[-1])) for lv in levels]
        assert images[0].shape == (24, 32, 3)
        np.testing.assert_array_equal(images[0], images[1])
        assert all(lv["metrics"]["time_ms"] > 0 for lv in levels)
    finally:
        stopped = installed.run("tools.serve", "stop", *opts)
    assert stopped.returncode == 0, stopped.stdout + stopped.stderr
    assert "Stopped backend" in stopped.stdout


def test_serve_without_a_checkout_needs_no_frontend(installed):
    port = _free_port()
    for command in ("start", "run"):
        proc = installed.run("tools.serve", command, "--device", "cpu",
                             "--port", str(port), "--run-dir",
                             str(installed.work / "run"))
        assert proc.returncode == 1
        assert "frontend/ not found" in proc.stderr
        assert "--no-frontend" in proc.stderr
        assert "Backend starting" not in proc.stdout
    assert not (installed.work / "run").exists() or not list(
        (installed.work / "run").glob("*.pid"))


def test_the_verification_tools_name_the_oracle(installed):
    proc = installed.run("tools.validation", "--device", "cpu", "--workers",
                         "0")
    assert proc.returncode != 0
    assert "tests/oracle_numpy.py not found" in proc.stderr
    assert not (installed.work / "silicon_out").exists()
