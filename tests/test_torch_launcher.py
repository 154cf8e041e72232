"""The port's host entry points on the CPU: the launcher
(tools/serve.py start/status/stop/run, on free ports, the backend at
`--device cpu`), the API client (tools/client.py, against an in-thread CPU
server and through the launcher), the examples at `--device cpu`, and the
import rule for the new modules.
"""

import importlib
import json
import pkgutil
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

import gpu_image_processing_tpu_torch as pkg
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.server.app import create_app
from gpu_image_processing_tpu_torch.server.http import AppServer
from gpu_image_processing_tpu_torch.tools import client, serve

ROOT = Path(__file__).resolve().parents[1]
#: The launcher's own wait for the backend's health, and the test's bound
#: on one launcher command.
HEALTH_TIMEOUT_S = 30
COMMAND_TIMEOUT_S = 60
OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(*args, run_dir, ports, device="cpu"):
    cmd = [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools.serve",
           *args, "--device", device, "--host", "127.0.0.1",
           "--port", str(ports[0]), "--frontend-port", str(ports[1]),
           "--run-dir", str(run_dir), "--timeout", str(HEALTH_TIMEOUT_S)]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=COMMAND_TIMEOUT_S)


def _get(url: str):
    with OPENER.open(url, timeout=10) as resp:
        return resp.status, resp.read()


@pytest.fixture
def ports():
    return _free_port(), _free_port()


def test_start_status_stop(tmp_path, ports):
    started = _serve("start", run_dir=tmp_path, ports=ports)
    try:
        assert started.returncode == 0, started.stdout + started.stderr
        assert "Backend healthy" in started.stdout
        pids = {name: serve.read_pid(str(tmp_path), name)
                for name in ("backend", "frontend")}
        assert all(pids.values()), pids
        assert (tmp_path / "gip_torch_backend.log").exists()
        status = _serve("status", run_dir=tmp_path, ports=ports).stdout
        assert f"backend: pid={pids['backend']} port_{ports[0]}=up" in status
        assert f"frontend: pid={pids['frontend']} port_{ports[1]}=up" in status
        code, body = _get(f"http://127.0.0.1:{ports[1]}/")
        assert code == 200
        assert body == (ROOT / "frontend" / "index.html").read_bytes()
        code, body = _get(f"http://127.0.0.1:{ports[0]}/api/health")
        assert json.loads(body) == {"status": "healthy", "gpu_available": True}
        # A second start finds the ports taken.
        again = _serve("start", run_dir=tmp_path, ports=ports)
        assert again.returncode == 1
        assert f"Port {ports[0]} already in use" in again.stdout
    finally:
        stopped = _serve("stop", run_dir=tmp_path, ports=ports)
    assert stopped.returncode == 0
    assert f"Stopped backend (pid {pids['backend']})" in stopped.stdout
    assert not any(serve.pid_alive(p) for p in pids.values())
    assert not serve.port_in_use(ports[0]) and not serve.port_in_use(ports[1])
    assert not list(tmp_path.glob("*.pid"))
    status = _serve("status", run_dir=tmp_path, ports=ports).stdout
    assert "backend: pid=- " in status and "=down" in status
    assert "backend not running" in _serve("stop", run_dir=tmp_path,
                                           ports=ports).stdout


def test_start_fails_without_the_device_it_asks_for(tmp_path, ports):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    started = _serve("start", run_dir=tmp_path, ports=ports, device="cuda")
    assert started.returncode == 1
    assert "Backend on cuda has no device" in started.stdout
    assert not serve.port_in_use(ports[0])
    assert serve.read_pid(str(tmp_path), "backend") is None


def test_a_backend_that_dies_fails_the_start_with_its_log(tmp_path, ports):
    cmd = [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools.serve",
           "start", "--device", "cpu", "--host", "203.0.113.1",
           "--port", str(ports[0]), "--frontend-port", str(ports[1]),
           "--run-dir", str(tmp_path), "--timeout", str(HEALTH_TIMEOUT_S)]
    started = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=COMMAND_TIMEOUT_S)
    assert started.returncode == 1
    assert "Backend exited with code 1 while starting" in started.stdout
    assert "Cannot assign requested address" in started.stdout   # the log's tail
    assert not serve.port_in_use(ports[1])


def test_run_stops_both_servers_on_sigterm(tmp_path, ports):
    cmd = [sys.executable, "-m", "gpu_image_processing_tpu_torch.tools.serve",
           "run", "--device", "cpu", "--host", "127.0.0.1",
           "--port", str(ports[0]), "--frontend-port", str(ports[1]),
           "--timeout", str(HEALTH_TIMEOUT_S)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        lines = []
        deadline = time.monotonic() + COMMAND_TIMEOUT_S
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if "Press Ctrl+C" in line or not line:
                break
        assert any("Press Ctrl+C" in line for line in lines), lines
        assert _get(f"http://127.0.0.1:{ports[1]}/")[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=COMMAND_TIMEOUT_S) == 0
        rest = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "Servers stopped." in rest
    pids = [int(m) for line in lines for m in re.findall(r"\(pid (\d+)", line)]
    assert len(pids) == 2 and not any(serve.pid_alive(p) for p in pids)
    assert not serve.port_in_use(ports[0]) and not serve.port_in_use(ports[1])


#: A process whose main thread exits while another thread, holding a
#: listening socket, runs on for `linger` seconds: its main thread turns
#: zombie first, as a server's does while a driver thread tears down.
_LINGERING = """
import ctypes, socket, sys, threading, time
s = socket.socket()
s.bind(("127.0.0.1", 0))
s.listen()
print(s.getsockname()[1], flush=True)
threading.Thread(target=time.sleep, args=(float(sys.argv[1]),)).start()
ctypes.CDLL(None).pthread_exit(None)
"""


def test_a_zombie_main_thread_with_a_live_thread_is_still_running():
    """`pid_alive` (and so `stop`) waits for a process's last thread: until
    then the process still holds its port."""
    child = subprocess.Popen([sys.executable, "-c", _LINGERING, "1.0"],
                             stdout=subprocess.PIPE, text=True,
                             start_new_session=True)
    try:
        port = int(child.stdout.readline())
        deadline = time.monotonic() + 10
        while "\tZ" not in Path(f"/proc/{child.pid}/status").read_text():
            assert time.monotonic() < deadline, "the main thread did not exit"
            time.sleep(0.01)
        assert serve.pid_alive(child.pid) and serve.port_in_use(port)
        while serve.pid_alive(child.pid):
            assert time.monotonic() < deadline, "the last thread did not end"
            time.sleep(0.02)
        assert not serve.port_in_use(port)
    finally:
        child.kill()
        child.wait()


def test_client_passes_every_check_against_a_cpu_server(tmp_path, capsys):
    server = AppServer(create_app(FilterRuntime("cpu")), "127.0.0.1", 0)
    server.start_background()
    try:
        rc = client.main(["--base", f"http://127.0.0.1:{server.port}",
                          "--outdir", str(tmp_path)])
    finally:
        server.shutdown()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("[PASS]") == 10 and "[FAIL]" not in out
    assert "10/10 tests passed" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "box_l2.png", "gaussian_l1.png", "gaussian_l2.png", "sobel_l4.png"]


def test_client_reports_an_unreachable_server(tmp_path, capsys):
    rc = client.main(["--base", f"http://127.0.0.1:{_free_port()}",
                      "--outdir", str(tmp_path)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "[FAIL] root endpoint" in out and "Server unreachable" in out


def test_hdr_upload_is_the_native_writers_file():
    import base64

    from gpu_image_processing_tpu_torch.utils import native_codec
    data = base64.b64decode(client.make_hdr_upload())
    assert data.startswith(b"#?RADIANCE")
    img = native_codec.hdr_decode(data)
    assert img.shape == (24, 32, 3)


@pytest.mark.parametrize("name,args,expect", [
    ("compose_filters", [], "-> out (480, 640, 3)"),
    ("profile_kernels", ["box"], "duration_source: wall_timing"),
    ("sharded_batch", [], "sharded result: (4, 128, 320, 3) on cpu"),
    ("wide_formats", [], "gaussian L2 on the 16-bit image's high byte (cpu)"),
])
def test_examples_run_on_the_cpu(capsys, name, args, expect):
    module = importlib.import_module(f"gpu_image_processing_tpu_torch.examples.{name}")
    assert module.main([*args, "--device", "cpu"]) == 0
    assert expect in capsys.readouterr().out


def test_examples_ask_for_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for name in ("compose_filters", "profile_kernels", "sharded_batch",
                 "wide_formats"):
        module = importlib.import_module(
            f"gpu_image_processing_tpu_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main([])


def test_the_new_modules_are_walked_by_the_import_check():
    """tests/test_torch_api.py::test_import_leaves_jax_out imports every
    module pkgutil walks; the host tier's modules are among them."""
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    for name in ("utils.image_io", "tools.filter_image", "tools.serve",
                 "tools.client", "examples.compose_filters",
                 "examples.profile_kernels", "examples.sharded_batch",
                 "examples.wide_formats"):
        assert f"{pkg.__name__}.{name}" in names
    for path in (ROOT / "gpu_image_processing_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "gpu_image_processing_tpu." not in text, path
