"""tools/silicon_ci.py: the stage runner (`run`), as tests/test_silicon_ci.py
holds the JAX one, except that a process that ignores SIGTERM is killed,
not left running; --skip, the report's directory, loadgen built by the host
compiler, and loadgen's lines."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gpu_image_processing_tpu_torch.ops.cuda import build
from gpu_image_processing_tpu_torch.tools import silicon_ci as ci
from gpu_image_processing_tpu_torch.core.files import ROOT_DIR
from gpu_image_processing_tpu_torch.tools.verification import OUT_DIR


def test_run_success_captures_tail():
    ok, secs, tail = ci.run([sys.executable, "-c", "print('hello ci')"], 60)
    assert ok and secs > 0
    assert "hello ci" in tail


def test_run_failure_reports_exit_code():
    ok, _, tail = ci.run([sys.executable, "-c", "raise SystemExit(3)"], 60)
    assert not ok
    assert "<exit 3>" in tail


def test_run_keeps_the_whole_output_in_its_log(tmp_path):
    log = tmp_path / "stage.log"
    ok, _, tail = ci.run([sys.executable, "-c",
                          "for i in range(20): print('line', i)"], 60, log)
    assert ok and tail.splitlines() == [f"line {i}" for i in range(12, 20)]
    assert log.read_text().splitlines() == [f"line {i}" for i in range(20)]


def test_run_timeout_terminates_gracefully():
    """A child past its limit gets SIGTERM and, well-behaved, exits: the
    stage fails without a SIGKILL."""
    t0 = time.time()
    ok, _, tail = ci.run([sys.executable, "-c",
                          "import time; time.sleep(600)"], 2)
    assert not ok
    assert time.time() - t0 < 30
    assert "ended by SIGTERM" in tail and "killed" not in tail


def test_run_timeout_kills_a_sigterm_ignorer():
    """A child that ignores SIGTERM is killed after the grace period, and
    the stage says so; nothing is left running."""
    # A shell trap arms before any signal can arrive.
    cmd = ["sh", "-c", 'trap "" TERM; echo armored; sleep 600']
    t0 = time.time()
    ok, _, tail = ci.run(cmd, 2, grace_s=2)
    assert not ok and time.time() - t0 < 30
    assert "SIGTERM ignored" in tail and "killed" in tail
    pid = int(tail.split("pid ")[1].split()[0])
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_skip_every_stage_writes_the_report(tmp_path, capsys):
    argv = ["--device", "cpu", "--out-dir", str(tmp_path)]
    for stage in ci.STAGES:
        argv += ["--skip", stage]
    assert ci.main(argv) == 0
    out = capsys.readouterr().out
    assert all(f"[skip] {s}" in out for s in ci.STAGES)
    report = json.loads((tmp_path / "silicon_ci.json").read_text())
    assert report["ok"] and report["device"] == "cpu"
    assert list(report["stages"]) == list(ci.STAGES)
    assert all(st == {"skipped": True} for st in report["stages"].values())


def test_a_failing_stage_fails_the_run(tmp_path, monkeypatch, capsys):
    def failing(name, args, out_dir):
        return False, 0.1, "<exit 1>", {}

    monkeypatch.setattr(ci, "tool_stage", failing)
    argv = ["--device", "cpu", "--out-dir", str(tmp_path), "--skip", "soak",
            "--skip", "sol", "--skip", "serving"]
    assert ci.main(argv) == 1
    assert "[FAIL] validate" in capsys.readouterr().out
    report = json.loads((tmp_path / "silicon_ci.json").read_text())
    assert not report["ok"] and not report["stages"]["validate"]["ok"]


def test_reports_go_to_a_gitignored_directory():
    # In the working directory, never in the package (a read-only install).
    assert OUT_DIR == Path("silicon_out")
    ignored = (ROOT_DIR / ".gitignore").read_text().splitlines()
    assert "silicon_out/" in ignored
    assert "benchmarks" not in str(OUT_DIR)


def test_raises_without_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ci.main(["--out-dir", str(tmp_path)])


def test_loadgen_builds_with_the_host_compiler():
    exe = build.build_loadgen()
    assert exe.parent == build.BUILD_DIR and exe.name.startswith("loadgen-")
    assert os.access(exe, os.X_OK)
    # Nothing listens on a fresh port: every request fails, and loadgen
    # says so in the lines the stage reads.
    proc = subprocess.run([str(exe), "127.0.0.1", str(ci.free_port()), "2",
                           "3"], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert ci.parse_loadgen(proc.stdout) == {
        "ok": 0, "failed": 6, "seconds": pytest.approx(
            ci.parse_loadgen(proc.stdout)["seconds"]), "req_per_s": 0.0}


def test_parse_loadgen():
    text = ("requests: 80 ok, 0 failed in 0.52 s (154.6 req/s)\n"
            "latency ms: p50=17.6 p90=52.2 p99=88.2 max=121.5\n")
    assert ci.parse_loadgen(text) == {
        "ok": 80, "failed": 0, "seconds": 0.52, "req_per_s": 154.6,
        "p50_ms": 17.6, "p90_ms": 52.2, "p99_ms": 88.2, "max_ms": 121.5}
    assert ci.parse_loadgen("") == {}


def test_full_size_payload_is_a_3239x2146_png():
    from gpu_image_processing_tpu_torch.utils import native_codec
    import base64

    payload = ci.full_size_payload()
    assert {k: payload[k] for k in ("filter", "sigma", "radius")} == ci.GAUSS
    png = base64.b64decode(payload["image"].split(",", 1)[1])
    img = native_codec.png_decode(png)
    assert img.shape == ci.FULL and img.dtype.name == "uint8"


def test_launcher_starts_ahead_and_stops_once(tmp_path):
    from gpu_image_processing_tpu_torch.tools import serve

    launcher = ci.Launcher("cpu", tmp_path / "serving")
    try:
        ok, secs, line = launcher.started()
        assert ok and secs > 0 and "healthy" in line
        pid = serve.read_pid(str(tmp_path / "serving"), "backend")
        assert pid and serve.port_in_use(launcher.port)
    finally:
        stopped = launcher.stop()
    assert stopped[0] and launcher.stop() is stopped
    assert not serve.port_in_use(launcher.port) and not serve.pid_alive(pid)


def test_exclusive_is_nothing_on_the_cpu():
    from gpu_image_processing_tpu_torch.runtime import timing

    with timing.exclusive([torch.device("cpu")] * 4):
        pass
    assert all(d.type == "cuda" for d in timing._CARDS)


@pytest.mark.cuda
def test_time_ms_under_concurrent_requests_reads_the_request_alone():
    # The threaded server's requests side by side on one card: each
    # gaussian L2 time_ms must read its own kernel, not another request's
    # spin, kernels or copies, nor a profiled request's runs, its untimed
    # first run included (runtime/timing.py::exclusive).
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    import statistics
    import threading

    import numpy as np

    from gpu_image_processing_tpu_torch.profiling.profiler import profile_filter
    from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

    rt = FilterRuntime("cuda")
    img = np.random.default_rng(5).integers(0, 256, ci.FULL, np.uint8)
    for level in (1, 2):
        rt.gaussian_blur(img, 2.0, 3, level)
    alone = [rt.gaussian_blur(img, 2.0, 3, 2)[1].time_ms for _ in range(9)]
    stop = threading.Event()

    def load():
        while not stop.is_set():
            rt.gaussian_blur(img, 2.0, 3, 1)   # copies and plain kernels
            rt.gaussian_blur(img, 2.0, 3, 2)

    profiled, failed = [], []

    def profile():
        # The profiled requests of the server, each on a fresh prepared call.
        while not stop.is_set():
            try:
                deep = profile_filter(rt, img, "gaussian", 2, sigma=2.0,
                                      radius=3)
            except Exception as exc:
                failed.append(repr(exc))
                return
            profiled.append(deep["total_kernel_duration_ms"])

    threads = [threading.Thread(target=load) for _ in range(4)]
    threads.append(threading.Thread(target=profile))
    for t in threads:
        t.start()
    try:
        under = [rt.gaussian_blur(img, 2.0, 3, 2)[1].time_ms
                 for _ in range(15)]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert profiled and not failed, failed
    base = statistics.median(alone)
    assert statistics.median(under) <= 1.2 * base, (alone, under)
    assert max(under) <= 1.5 * base, (alone, under)
