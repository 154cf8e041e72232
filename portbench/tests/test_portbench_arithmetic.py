"""The readers' arithmetic on synthetic inputs: percentiles, rates, the
idle share from a trace, the least time of a filter call, the counters'
deltas, and the schedule's balance."""

from __future__ import annotations

import json
import statistics
from collections import Counter

import numpy as np
import pytest

from portbench.harness import schedule, spec, stats
from portbench.harness.check import Comparison
from portbench.harness.trace import Trace, summarize
from portbench.reference import work

CALLS = [(0.0, 0.5, True), (0.5, 1.2, True), (1.2, 2.1, True),
         (2.1, 3.4, False), (3.4, 4.0, True)]


def _read(kind: str, name: str, obs: dict):
    return spec.load_reader(kind, name).read(obs)


def test_percentiles_and_rates():
    assert stats.percentile([5.0], 90) == 5.0
    values = list(range(1, 101))
    assert stats.percentile(values, 90) == pytest.approx(90.1)
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    # Completed inside [0, 3.5] and succeeded: the first three.
    assert stats.completed_rate(CALLS, 0.0, 3.5) == pytest.approx(3 / 3.5)
    lat = stats.latencies_ms(CALLS, 0.0, 3.5)
    assert lat == pytest.approx([500, 700, 900, 1300, 600])


def test_the_end_to_end_readers():
    obs = {"calls": CALLS, "t0": 0.0, "t1": 3.5, "setup_s": 12.5}
    for rate in ("images_per_s", "frames_per_s", "requests_per_s"):
        assert _read("end_to_end", rate, obs) == pytest.approx(3 / 3.5)
    lat = [500, 700, 900, 1300, 600]
    assert _read("end_to_end", "request_p90_ms", obs) == pytest.approx(
        statistics.quantiles(lat, n=100, method="inclusive")[89])
    assert _read("end_to_end", "setup_s", obs) == 12.5


def test_the_server_phase_readers():
    before = {"phase": {"requests": 2, "decode": 100.0, "run": 10.0,
                        "encode": 200.0, "profile": 0.0}}
    after = {"phase": {"requests": 6, "decode": 500.0, "run": 50.0,
                       "encode": 1000.0, "profile": 0.0}}
    calls = [(0.0, 0.5, True), (0.1, 0.6, True), (0.2, 0.7, True),
             (0.3, 0.8, True)]
    obs = {"before": before, "after": after, "calls": calls, "t0": 0.0,
           "t1": 1.0}
    assert _read("metrics", "codec.ms_per_req", obs) == pytest.approx(300.0)
    assert _read("metrics", "runtime.run_ms_per_req", obs) == pytest.approx(
        10.0)
    # 2000 ms of client wall less 1240 ms of phases, over 4 requests.
    assert _read("metrics", "http.outside_ms_per_req", obs) == pytest.approx(
        190.0)
    assert _read("metrics", "codec.ms_per_req",
                 {"before": {}, "after": {}}) is None


def test_the_key_held_share():
    obs = {"before": {"executables": {"requests": 10, "hits": 4}},
           "after": {"executables": {"requests": 110, "hits": 99}}}
    assert _read("metrics", "exec.key_held_pct", obs) == pytest.approx(95.0)


def test_the_idle_share_and_the_gaps():
    t = summarize([("kernel", "k", 100, 400), ("gpu_memcpy", "m", 300, 500),
                   ("cuda_runtime", "cudaStreamSynchronize", 550, 950),
                   ("cpu_op", "aten::add", 0, 1000)], 0, 1000)
    assert t.busy_s == pytest.approx(400e-9)
    assert t.idle_pct == pytest.approx(60.0)
    assert t.idle_by_host == pytest.approx(
        {"host code, no CUDA call": 100e-9, "cudaStreamSynchronize": 500e-9})
    assert t.breakdown()["device_ops"][0] == ["k", pytest.approx(300e-9)]
    for name in ("device.idle_pct.ui", "device.idle_pct.lib"):
        assert _read("metrics", name, {"trace": t}) == pytest.approx(60.0)
        assert _read("metrics", name, {"trace": None}) is None
    with pytest.raises(RuntimeError):
        summarize([("cuda_runtime", "cudaMalloc", 0, 10)], 0, 100)


def test_the_least_time_of_a_call_by_filter_function():
    shape = (1, 2146, 3239, 3)
    nbytes = 2 * 2146 * 3239 * 3
    bytes_s = nbytes / 3.35e12
    assert work.least_seconds("box", 2, shape, 5) == pytest.approx(bytes_s)
    assert work.least_seconds("sobel", 2, shape, 0) == pytest.approx(bytes_s)
    # The gaussian at r = 3: 2 passes x 14 operations an element.
    ops_s = 28 * 2146 * 3239 * 3 / 67e12
    assert ops_s < bytes_s
    assert work.least_seconds("gaussian", 2, shape, 3) == pytest.approx(
        bytes_s)
    # At r = 15, 124 operations an element: bound by operations.
    assert work.least_seconds("gaussian", 2, shape, 15) == pytest.approx(
        124 * 2146 * 3239 * 3 / 67e12)
    # The level does not change the work: the function is the same.
    assert work.least_seconds("gaussian", 4, shape, 3) == \
        work.least_seconds("gaussian", 2, shape, 3)


def test_the_roofline_share():
    t = Trace(window_s=1.0, busy_s=0.5)
    shape = (4, 100, 200, 3)
    wk = [("box", 2, shape, 5)] * 10
    need = 10 * work.least_seconds("box", 2, shape, 5)
    assert _read("metrics", "kernels_roofline",
                 {"trace": t, "work": wk}) == pytest.approx(200 * need)
    assert _read("metrics", "kernels_roofline",
                 {"trace": None, "work": wk}) is None


def test_the_comparison_counts_and_limits():
    import torch

    numerics = spec.load("lib_photo.api_repeat").config["numerics"]
    want = torch.zeros(10, 10, 3, dtype=torch.uint8)
    got = want.clone()
    got[0, 0, 0] = 3
    cmp = Comparison(numerics)
    cmp.add(want.clone(), want, "gaussian", 2)
    assert cmp.correct and "near_worst_share_pct" not in cmp.numbers()
    cmp.add(got, want, "sobel", 2)     # within 6 on 1 byte of 300
    n = cmp.numbers()
    assert n["near_worst_share_pct"]["value"] == pytest.approx(100 / 300)
    assert n["near_worst_share_pct"]["limit"] == 0.1 and not cmp.correct
    cmp = Comparison(numerics)
    cmp.add(got, want, "box", 4)
    assert cmp.numbers()["exact_bytes_off"]["value"] == 1 and not cmp.correct
    cmp = Comparison(numerics)
    cmp.add(torch.zeros(3, 3, 3, dtype=torch.uint8), want, "box", 2)
    assert cmp.numbers()["unreadable_answers"]["value"] == 1
    assert not Comparison(numerics).correct    # nothing compared


def test_a_block_is_balanced_and_seeded():
    mix = json.loads((spec.BENCH_DIR / "traffic/api_repeat.json")
                     .read_text())
    config = spec.load("lib_photo.api_repeat").config
    a = schedule.block(mix, config, np.random.default_rng(1))
    b = schedule.block(mix, config, np.random.default_rng(2))
    assert len(a) == 6
    work = Counter((c.filter, c.level, c.sigma, c.radius, c.size) for c in a)
    assert work == Counter((c.filter, c.level, c.sigma, c.radius, c.size)
                           for c in b)
    assert work == Counter(c.key() for c in schedule.distinct_work(mix,
                                                                   config))
    assert {(c.filter, c.sigma, c.radius) for c in a} == {
        ("gaussian", 2.0, 3), ("box", 0.0, 5), ("sobel", 0.0, 0)}
    assert all(0 <= c.image < mix["pool"] for c in a)
    assert a != b
    assert a == schedule.block(mix, config, np.random.default_rng(1))
