"""The port's span recorder (core/spans.py), the spans and counters of its
layers, and the benchmark's readers of them (portbench/).

The recorder: off, one shared object and nothing recorded; on, nesting,
parents, self time, request ids, threads, capacity and the clock.  The
layers on the CPU: a process-all over a real socket and the API path.  The
benchmark: idle gaps labelled by spans, and each reader on a synthetic
observation.  The `cuda` tests hold the capture's span and counters, and
the recorder's clock against `torch.profiler`'s, on the card; this file
imports neither JAX nor the JAX package, so they run there.
"""

import base64
import json
import statistics
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu_torch.core import config, spans
from gpu_image_processing_tpu_torch.runtime import timing
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.server.app import create_app
from gpu_image_processing_tpu_torch.server.http import AppServer
from gpu_image_processing_tpu_torch.utils.image import encode_png
from portbench.harness import program_spans, spec
from portbench.harness import trace as plain_trace

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def recorder_off_after():
    spans.disable()
    yield
    spans.disable()


def _image(seed: int, shape=(24, 31, 3)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _by_name(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


# -- the recorder ----------------------------------------------------------


def test_off_every_span_is_one_object_and_nothing_is_recorded():
    a, b = spans.span("a"), spans.span("b")
    assert a is b and spans.request("r") is a
    with a, spans.span("c"), spans.request("d"):
        pass
    assert spans.totals() == {} and spans.records() == []
    assert spans.dropped() == 0
    spans.enable()
    assert spans.totals() == {}   # nothing carried over from off


def test_a_stamped_span_times_on_and_off():
    with spans.stamped("x") as s:
        time.sleep(0.002)
    assert s.ms >= 2.0 and spans.totals() == {}
    spans.enable()
    with spans.stamped("x") as s:
        pass
    assert spans.totals()["x"]["ms"] == pytest.approx(s.ms, abs=1e-9)


def test_nesting_parents_and_self_time():
    spans.enable()
    with spans.span("outer"):
        time.sleep(0.003)
        with spans.span("inner"):
            time.sleep(0.004)
            with spans.span("leaf"):
                pass
        with spans.span("inner"):
            pass
    tot = spans.totals()
    assert tot["inner"]["count"] == 2 and tot["outer"]["count"] == 1
    assert tot["outer"]["ms"] >= tot["inner"]["ms"] + 3.0
    assert tot["outer"]["self_ms"] == pytest.approx(
        tot["outer"]["ms"] - tot["inner"]["ms"], abs=1e-6)
    assert tot["inner"]["self_ms"] == pytest.approx(
        tot["inner"]["ms"] - tot["leaf"]["ms"], abs=1e-6)
    assert tot["leaf"]["self_ms"] == pytest.approx(tot["leaf"]["ms"])
    rec = _by_name(spans.records())
    assert [r.parent for r in rec["inner"]] == ["outer", "outer"]
    assert rec["leaf"][0].parent == "inner" and rec["outer"][0].parent is None
    (outer,) = rec["outer"]
    for r in rec["inner"] + rec["leaf"]:
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
    # Closed in order: the leaf first, the outer span last.
    assert [r.name for r in spans.records()] == ["leaf", "inner", "inner",
                                                "outer"]


def test_one_request_id_across_a_requests_spans():
    spans.enable()
    for _ in range(2):
        with spans.request("http.request"):
            with spans.span("server.decode"):
                with spans.request("runtime.call"):   # inside: no new id
                    with spans.span("exec.stage"):
                        pass
    with spans.span("outside"):
        pass
    with spans.request("runtime.call"):   # a library call opens its own
        pass
    ids = [(r.name, r.request) for r in spans.records()]
    first, second = {i for _, i in ids[:4]}, {i for _, i in ids[4:8]}
    assert len(first) == len(second) == 1 and first != second
    assert None not in first | second
    assert ids[8] == ("outside", None)
    assert ids[9][1] not in first | second | {None}


def test_eight_threads_keep_their_own_stacks_and_requests():
    spans.enable()
    n_threads, n_requests = 8, 60
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30)
        for _ in range(n_requests):
            with spans.request("req"):
                with spans.span("mid"):
                    with spans.span("leaf"):
                        pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    tot = spans.totals()
    for name in ("req", "mid", "leaf"):
        assert tot[name]["count"] == n_threads * n_requests
    records = spans.records()
    assert len(records) == 3 * n_threads * n_requests
    assert len({r.thread for r in records}) == n_threads
    by_request: dict = {}
    for r in records:
        by_request.setdefault(r.request, []).append(r)
    assert len(by_request) == n_threads * n_requests
    for group in by_request.values():
        assert sorted(r.name for r in group) == ["leaf", "mid", "req"]
        assert len({r.thread for r in group}) == 1
        parents = {r.name: r.parent for r in group}
        assert parents == {"req": None, "mid": "req", "leaf": "mid"}


def test_capacity_bounds_the_records_not_the_totals():
    spans.enable(capacity=3)
    for _ in range(5):
        with spans.span("a"):
            pass
    assert len(spans.records()) == 3 and spans.dropped() == 2
    assert spans.totals()["a"]["count"] == 5


def test_records_are_on_the_unix_epoch_clock():
    spans.enable()
    before = time.time_ns()
    with spans.span("a"):
        time.sleep(0.001)
    after = time.time_ns()
    (r,) = spans.records()
    assert abs(r.start_ns - before) < 5_000_000
    assert abs(r.end_ns - after) < 5_000_000
    assert r.end_ns - r.start_ns >= 1_000_000


# -- the layers on the CPU -------------------------------------------------


def _post(base: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return json.loads(resp.read())


def test_process_all_over_a_socket_records_every_layers_spans():
    spans.enable()
    server = AppServer(create_app(FilterRuntime("cpu")), "127.0.0.1", 0)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    try:
        url = "data:image/png;base64," + base64.b64encode(
            encode_png(_image(3))).decode()
        for f in ("sobel", "box"):
            reply = _post(base, "/api/process-all",
                          {"image": url, "filter": f, "radius": 2,
                           "enable_profiling": f == "sobel"})
            assert set(reply["results"]) == {"level_1", "level_2"}
        stats = _get(base, "/api/stats")
    finally:
        server.shutdown()
    tot = stats["spans"]
    for name in ("http.request", "http.read", "http.parse", "http.dump",
                 "http.write", "server.decode", "server.run",
                 "server.encode", "server.profile", "codec.b64decode",
                 "codec.decode", "codec.encode", "codec.b64encode",
                 "runtime.call", "runtime.bracket", "exec.stage",
                 "exec.fetch", "exec.build"):
        assert tot[name]["count"] >= 1, name
    assert tot["http.read"]["count"] == 2      # the two POSTs' bodies
    assert tot["runtime.call"]["count"] == 4   # two levels each
    phases = stats["phase_ms"]["POST /api/process-all"]
    assert phases["requests"] == 2
    for phase in ("decode", "run", "encode", "profile"):
        assert tot[f"server.{phase}"]["ms"] == pytest.approx(
            phases[phase], rel=1e-9, abs=1e-9)
    # The upload passes through; the Sobel answers are two encodes, the
    # box's one (level 2 equals level 1).
    assert tot["codec.encode"]["count"] == 3
    assert stats["timing"]["brackets"] >= 4 * config.TIMING_REPS
    # Every span of a request shares its id.
    groups: dict = {}
    for r in spans.records():
        groups.setdefault(r.request, set()).add(r.name)
    posts = [g for g in groups.values() if "server.run" in g]
    assert len(posts) == 2
    for g in posts:
        assert {"http.request", "http.read", "codec.decode", "runtime.call",
                "exec.stage", "http.write"} <= g


def test_stats_without_the_recorder_give_empty_spans():
    from gpu_image_processing_tpu_torch.server.http import Request

    app = create_app(FilterRuntime("cpu"))
    stats = app.dispatch(Request(method="GET", path="/api/stats"))[1]
    assert stats["spans"] == {}
    assert set(stats["timing"]) == {"brackets", "reruns"}


def test_server_main_turns_the_recorder_on_with_spans(monkeypatch):
    from gpu_image_processing_tpu_torch.server import app as app_module

    seen = {}

    def stop(self):
        with spans.span("probe"):
            pass
        seen["on"] = "probe" in spans.totals()

    monkeypatch.setattr(app_module.AppServer, "serve_forever", stop)
    monkeypatch.setattr(app_module, "warm_kernels", lambda rt: None)
    monkeypatch.setattr("signal.signal", lambda *a: None)
    app_module.main(["--device", "cpu", "--port", "0"])
    assert seen == {"on": False}
    app_module.main(["--device", "cpu", "--port", "0", "--spans"])
    assert seen == {"on": True}


def test_the_api_path_records_stage_bracket_fetch_and_build():
    spans.enable()
    rt = FilterRuntime("cpu")
    img = _image(5)
    before = timing.stats()
    for _ in range(3):
        rt.box_blur(img, radius=2, level=2)
    tot = spans.totals()
    for name in ("runtime.call", "exec.wait", "exec.stage",
                 "runtime.bracket", "exec.fetch"):
        assert tot[name]["count"] == 3, name
    assert tot["exec.build"]["count"] == 1
    assert "exec.capture" not in tot   # no graph on the CPU
    after = timing.stats()
    assert after["brackets"] - before["brackets"] == 3 * config.TIMING_REPS
    assert after["reruns"] == before["reruns"]   # the CPU never reruns
    stats = rt.executables.stats()
    assert (stats["builds"], stats["captures"], stats["capture_ms"]) == (
        1, 0, 0.0)
    assert stats["build_ms"] == pytest.approx(tot["exec.build"]["ms"])
    # The call's spans nest in it, under one request each.
    rec = spans.records()
    calls = [r for r in rec if r.name == "runtime.call"]
    for r in rec:
        (call,) = [c for c in calls if c.request == r.request]
        assert call.start_ns <= r.start_ns <= r.end_ns <= call.end_ns


def test_the_cache_keeps_an_evicted_keys_build_time():
    rt = FilterRuntime("cpu")
    rt.executables.limit = 1
    img = _image(6, (9, 10, 3))
    for radius in (1, 2, 3):
        rt.box_blur(img, radius=radius, level=2)
    stats = rt.executables.stats()
    assert stats["evictions"] == 2 and stats["executables"] == 1
    assert stats["builds"] == 3 and stats["build_ms"] > 0


def test_models_forward_is_a_span():
    from gpu_image_processing_tpu_torch.models.filters import get_filter

    spans.enable()
    frame = torch.from_numpy(_image(7))
    for name in ("gaussian", "box", "sobel"):
        get_filter(name)(frame)
    assert spans.totals()["models.forward"]["count"] == 3


# -- the benchmark's readers and labels ------------------------------------


def _events():
    """Device work at [100, 200] and [400, 500] in a window [0, 1000]; a
    CUDA call over [220, 260]."""
    return [("kernel", "k", 100, 200), ("gpu_memcpy", "c", 400, 500),
            ("cuda_runtime", "cudaStreamSynchronize", 220, 260)]


def test_summarize_without_spans_is_the_plain_trace():
    got = program_spans.summarize(_events(), 0, 1000)
    want = plain_trace.summarize(_events(), 0, 1000)
    assert got == want
    assert program_spans.summarize(_events(), 0, 1000, []) == want


def test_summarize_labels_a_gap_by_the_innermost_span():
    # Gaps: [0, 100] mid 50, [200, 400] mid 300, [500, 1000] mid 750.
    spans_ = [(0, 1000, "runtime.call"), (10, 90, "exec.stage"),
              (280, 320, "exec.fetch"), (600, 700, "exec.build")]
    t = program_spans.summarize(_events(), 0, 1000, spans_)
    assert t.idle_by_host == pytest.approx({
        "host in exec.stage": 100e-9, "host in exec.fetch": 200e-9,
        "host in runtime.call": 500e-9})
    plain = plain_trace.summarize(_events(), 0, 1000)
    assert sum(t.idle_by_host.values()) == pytest.approx(
        sum(plain.idle_by_host.values()))
    assert (t.busy_s, t.window_s, t.device_ops) == (
        plain.busy_s, plain.window_s, plain.device_ops)
    # A CUDA call at the middle wins over a span; no span keeps the label.
    events = _events() + [("cuda_runtime", "cudaMemcpyAsync", 290, 310)]
    t = program_spans.summarize(events, 0, 1000, [(600, 700, "exec.build")])
    assert t.idle_by_host == pytest.approx({
        program_spans.NO_CALL: 600e-9, "cudaMemcpyAsync": 200e-9})


def test_innermost_is_the_latest_start_across_threads():
    spans_ = [(0, 100, "a"), (20, 60, "b"), (30, 40, "c"), (50, 90, "d")]
    assert program_spans._innermost(spans_, [10, 25, 35, 45, 55, 95, 200]) == [
        "a", "b", "c", "b", "d", "a", None]


def _reader(name: str):
    return spec.load_reader("metrics", name)


def _obs(before: dict, after: dict, phase=(0, 0)) -> dict:
    return {"before": {"spans": before, "phase": {"requests": phase[0]}},
            "after": {"spans": after, "phase": {"requests": phase[1]}}}


def _tot(**ms) -> dict:
    return {k.replace("_", "."): {"count": v[0], "ms": v[1],
                                  "self_ms": v[2] if len(v) > 2 else v[1]}
            for k, v in ms.items()}


UI_BEFORE = _tot(http_parse=(1, 5.0), http_dump=(1, 7.0), http_read=(1, 2.0),
                 http_write=(1, 3.0), codec_decode=(1, 300.0),
                 codec_encode=(2, 400.0), codec_b64decode=(1, 20.0),
                 codec_b64encode=(3, 30.0))
UI_AFTER = _tot(http_parse=(5, 45.0), http_dump=(9, 87.0),
                http_read=(5, 22.0), http_write=(9, 43.0),
                codec_decode=(5, 1500.0), codec_encode=(12, 2800.0),
                codec_b64decode=(5, 100.0), codec_b64encode=(15, 150.0))


@pytest.mark.parametrize("name,want", [
    ("http.json_ms_per_req", (40.0 + 80.0) / 4),
    ("http.socket_ms_per_req", (20.0 + 40.0) / 4),
    ("codec.decode_ms_per_req", 1200.0 / 4),
    ("codec.encode_ms_per_req", 2400.0 / 4),
    ("codec.base64_ms_per_req", (80.0 + 120.0) / 4),
])
def test_ui_readers(name, want):
    obs = _obs(UI_BEFORE, UI_AFTER, (6, 10))
    assert _reader(name).read(obs) == pytest.approx(want)
    assert _reader(name).read({"before": {}, "after": {}}) is None
    assert _reader(name).read(_obs({}, {}, (6, 10))) is None
    assert _reader(name).read(_obs(UI_BEFORE, UI_AFTER, (6, 6))) is None


@pytest.mark.parametrize("name,want", [
    ("exec.stage_ms_per_call", 120.0 / 100),
    ("exec.fetch_ms_per_call", 90.0 / 100),
    ("runtime.bracket_ms_per_call", 60.0 / 100),
])
def test_repeat_readers(name, want):
    before = _tot(runtime_call=(10, 35.0), exec_stage=(10, 12.0),
                  exec_fetch=(10, 9.0), runtime_bracket=(10, 6.0))
    after = _tot(runtime_call=(110, 385.0), exec_stage=(110, 132.0),
                 exec_fetch=(110, 99.0), runtime_bracket=(110, 66.0))
    assert _reader(name).read(_obs(before, after)) == pytest.approx(want)
    assert _reader(name).read(_obs(before, before)) is None   # no call
    assert _reader(name).read({"before": {}, "after": {}}) is None


def test_rerun_share_reader():
    read = _reader("timing.rerun_pct").read
    obs = {"before": {"timing": {"brackets": 10, "reruns": 1}},
           "after": {"timing": {"brackets": 210, "reruns": 5}}}
    assert read(obs) == pytest.approx(2.0)
    assert read({"before": {}, "after": {}}) is None
    obs["after"]["timing"] = {"brackets": 10, "reruns": 1}
    assert read(obs) is None


@pytest.mark.parametrize("name,want", [
    ("models.self_us_per_frame", 1000.0 * 4.0 / 200),
    ("ops.launch_us_per_frame", 1000.0 * 5.0 / 200),
])
def test_forward_readers(name, want):
    before = _tot(models_forward=(50, 3.0, 1.0), ops_launch=(50, 2.0))
    after = _tot(models_forward=(250, 12.0, 5.0), ops_launch=(250, 7.0))
    assert _reader(name).read(_obs(before, after)) == pytest.approx(want)
    assert _reader(name).read({"before": {}, "after": {}}) is None


def test_build_capture_reader_reads_the_set_up():
    read = _reader("exec.build_capture_s").read
    obs = {"before": {"executables": {"build_ms": 1500.0,
                                      "capture_ms": 250.0}},
           "after": {"executables": {"build_ms": 9e9, "capture_ms": 9e9}}}
    assert read(obs) == pytest.approx(1.75)
    # A program whose cache keeps no build time reads nothing.
    assert read({"before": {"executables": {"requests": 3}},
                 "after": {}}) is None
    assert read({"before": {}, "after": {}}) is None


def test_the_readers_entries_name_their_files_and_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    extra = json.loads((ROOT / "portbench/program_spans.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["per_layer"] + extra["per_layer"]]
    assert len(names) == len(set(names))
    counters = [m for m in bench["per_layer"]
                if m["name"] == "exec.build_capture_s"]
    for m in extra["per_layer"] + counters:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
        assert m["source"] in ("program_span", "program_counter")
        assert set(m["workloads"]) <= cells and m["workloads"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert callable(_reader(m["name"]).read)
    for cell in cells:
        got = [m["name"] for m, _ in program_spans.extra_metrics(cell)]
        assert got == [m["name"] for m in extra["per_layer"]
                       if cell in m["workloads"]]


# -- on the card -----------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_capture_is_a_span_and_counted():
    dev = _card()
    spans.enable()
    rt = FilterRuntime(dev)
    img = _image(8, (61, 97, 3))
    for _ in range(3):
        rt.box_blur(img, radius=2, level=2)
    tot = spans.totals()
    stats = rt.executables.stats()
    assert tot["exec.build"]["count"] == tot["exec.capture"]["count"] == 1
    assert (stats["builds"], stats["captures"]) == (1, 1)
    assert stats["capture_ms"] == pytest.approx(tot["exec.capture"]["ms"])
    assert stats["build_ms"] == pytest.approx(tot["exec.build"]["ms"])
    assert tot["ops.launch"]["count"] >= 1   # the eager and captured runs
    (exe,) = rt.executables.values()
    assert 0 < exe.capture_ms <= stats["capture_ms"]


@pytest.mark.cuda
def test_spans_lie_on_the_profilers_clock():
    """200 spans around `torch.cuda.synchronize()` under `torch.profiler`
    (CUDA activity, as the benchmark traces): in 198 or more the trace's
    synchronize call lies inside its span widened by 50 us at each end.
    Prints the median offsets of the call's start and end inside its
    span."""
    from torch.profiler import ProfilerActivity, profile

    _card()
    torch.cuda.synchronize()
    spans.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            with spans.span("sync"):
                torch.cuda.synchronize()
            time.sleep(0.0005)
    calls = sorted((int(e.start_ns()), int(e.end_ns()))
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "cudaDeviceSynchronize")
    recs = sorted((r.start_ns, r.end_ns) for r in spans.records())
    assert len(recs) == 200 and len(calls) >= 200
    inside, starts, ends = 0, [], []
    for s, e in recs:
        best = min(calls, key=lambda c: abs(c[0] - s))
        starts.append(best[0] - s)
        ends.append(e - best[1])
        inside += s - 50_000 <= best[0] and best[1] <= e + 50_000
    print(f"clock: {inside}/200 inside; median start offset "
          f"{statistics.median(starts) / 1e3:.2f} us, end offset "
          f"{statistics.median(ends) / 1e3:.2f} us")
    assert inside >= 198
