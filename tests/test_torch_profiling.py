"""The port's deep profiling (profiling/profiler.py, profiling/traffic.py):
the contract of tests/test_models_profiling.py (sections of the
categorized dict, the flattened UI keys, the primary time never displaced,
percentages only against a known card's peaks), adapted to a profiler whose
every kernel runs both passes in one launch, and held against the JAX
package's profiler on the same CPU call.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.profiling import profiler as jax_profiler
from gpu_image_processing_tpu_torch.core.config import GAUSS_MXU_MIN_RADIUS
from gpu_image_processing_tpu_torch.profiling import profiler, traffic
from gpu_image_processing_tpu_torch.profiling.profiler import (
    PEAKS,
    check_profiler_available,
    device_peaks,
    get_common_metrics,
    profile_batch,
    profile_filter,
)
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

from .conftest import make_image

H100 = "NVIDIA H100 80GB HBM3"
CASES = [("gaussian", 2, 2.0, 3), ("gaussian", 1, 2.0, 3), ("gaussian", 4, 2.0, 3),
         ("box", 2, None, 2), ("box", 1, None, 2), ("sobel", 2, None, None),
         ("sobel", 4, None, None)]


@pytest.fixture(scope="module")
def cpu():
    return FilterRuntime("cpu")


def test_profiler_available():
    assert check_profiler_available("cpu") is True
    if not torch.cuda.is_available():
        assert check_profiler_available("cuda") is False


def test_profile_filter_contract(rng, cpu):
    img = make_image(rng, 16, 20, 3)
    deep = profile_filter(cpu, img, "gaussian", 2, sigma=2.0, radius=3)
    for section in ("execution", "memory", "occupancy", "config"):
        assert section in deep
    assert deep["total_kernel_duration_ms"] > 0
    # One launch serves both passes: one row, and no per-pass split.
    assert deep["kernels_profiled"] == ["gaussian_blur_fused_l2"]
    assert "per_pass_durations_ms" not in deep
    assert "one launch" in deep["config"]["Per-Pass Durations"]
    assert deep["occupancy"] == {}
    assert "not measured" in deep["config"]["Occupancy"]
    assert deep["duration_source"] == "wall_timing"
    assert deep["bytes_source"] == "modeled"
    assert deep["execution"]["Launch Count"] == profiler.PROFILE_REPS

    common = get_common_metrics(deep, ncu_data=deep)
    assert common["time_ms"] == deep["total_kernel_duration_ms"] > 0
    assert common["total_kernels"] == 1
    assert common["kernel_durations"] == [deep["execution"]["Duration (ms)"]]
    assert "memory_throughput_gbps" in common
    assert "occupancy_pct" not in common
    assert common["kernel_duration_source"] == "wall_timing"


@pytest.mark.parametrize("filt,level,sigma,radius", CASES)
def test_profile_filter_names_the_served_function(rng, cpu, filt, level, sigma,
                                                  radius):
    img = make_image(rng, 12, 15, 3)
    deep = profile_filter(cpu, img, filt, level, sigma=sigma, radius=radius)
    assert deep["kernels_profiled"] == [profiler._kernel_label(filt, level)]
    assert deep["memory"]["Argument Bytes"] == img.size
    assert deep["memory"]["IO Throughput (Gbyte/s)"] == pytest.approx(
        2 * img.size / (deep["total_kernel_duration_ms"] / 1e3) / 1e9)
    assert "Peak Table" in deep["config"]


def test_profile_first_run_holds_the_timing_lock(rng, cpu, monkeypatch):
    """A profile's untimed first run holds the card's timing lock, as the
    runtime's own first run does, so it never lands in another request's
    bracket; the lock is released before the measured runs (the CPU's take
    none), which take the session lock first."""
    held, inside = [], []

    @contextlib.contextmanager
    def spy(devices):
        held.append(tuple(devices))
        try:
            yield
        finally:
            held.pop()

    monkeypatch.setattr(profiler, "exclusive", spy)
    prepare = cpu._single_call

    def spied(*args, **kwargs):
        call = prepare(*args, **kwargs)

        def run():
            inside.append(list(held))
            return call.run()

        return call._replace(run=run)

    monkeypatch.setattr(cpu, "_single_call", spied)
    profile_filter(cpu, make_image(rng, 16, 20, 3), "gaussian", 2, sigma=2.0,
                   radius=3)
    assert inside[0] == [(torch.device("cpu"),)]
    assert inside[1:] == [[]] * profiler.PROFILE_REPS


def test_profile_batch_contract(rng, cpu):
    imgs = np.stack([make_image(rng, 10, 13, 3) for _ in range(3)])
    deep = profile_batch(cpu, imgs, "box", 2, radius=2)
    assert deep["kernels_profiled"] == ["box_batch_l2"]
    assert deep["config"]["Batch Size"] == 3
    assert deep["config"]["Serving Path"] == "batch"
    assert deep["config"]["Image Shape"] == "3x10x13x3"
    assert deep["memory"]["Argument Bytes"] == imgs.size
    assert get_common_metrics(deep)["time_ms"] > 0


def test_common_metrics_empty():
    assert get_common_metrics({}) == {}
    assert get_common_metrics(None) == {}


def test_device_peaks_per_card():
    """One table, keyed by the card's name; chip_smoke.py's bound reads it."""
    peaks = device_peaks(H100)
    assert peaks == PEAKS[H100]
    assert peaks.hbm_bytes_per_s == 3.35e12
    assert peaks.f32_ops_per_s == pytest.approx(33.45e12, rel=1e-3)
    assert peaks.bf16_tensor_ops_per_s == 989e12
    assert device_peaks("NVIDIA H100 PCIe") is None
    assert device_peaks("cpu") is None
    assert device_peaks(None) is None


def test_cpu_profile_omits_percentages(rng, cpu):
    img = make_image(rng, 16, 20, 3)
    deep = profile_filter(cpu, img, "box", 2, radius=2)
    assert "DRAM Throughput (% of peak)" not in deep["memory"]
    assert "no trusted peak table for 'cpu'" in deep["config"]["Peak Table"]
    assert deep["memory"]["Peak Device Memory (bytes)"] is None
    common = get_common_metrics(deep, ncu_data=deep)
    assert "dram_throughput_pct" not in common
    assert "peak_device_memory_bytes" not in common
    assert common["time_ms"] > 0


def _card_profile(monkeypatch, name, filt="gaussian", level=2, radius=3):
    """The dict `profile_filter` assembles from a trace of a card named
    `name` (the assembly is host code; the trace rows are given)."""
    monkeypatch.setattr(profiler, "_device_name", lambda device: name)
    kernels = {"gauss_window_rows<gip::Weighted, 3>": {
        "count": 4, "total_ms": 0.28, "avg_ms": 0.07, "per_call_ms": 0.07}}
    shape = (2146, 3239, 3)
    return profiler._assemble(
        device=torch.device("cuda"), times_ms=[0.07] * 4, kernels=kernels,
        peak_bytes=41_709_568, reps=4, label="gaussian_blur_fused_l2",
        shape=shape, tensor_flops=traffic.served_tensor_core_flops(
            filt, level, *shape, radius), extra_config={})


def test_utilization_pct_uses_io_floor(monkeypatch):
    deep = _card_profile(monkeypatch, H100)
    mem = deep["memory"]
    io_gbps = mem["IO Throughput (Gbyte/s)"]
    assert io_gbps == pytest.approx(2 * 2146 * 3239 * 3 / 0.07e-3 / 1e9)
    assert mem["DRAM Throughput (% of peak)"] == pytest.approx(
        100.0 * io_gbps / deep["config"]["Peak HBM Bandwidth (Gbyte/s)"])
    assert deep["kernel_durations_ms"] == {
        "gauss_window_rows<gip::Weighted, 3>": pytest.approx(0.07)}
    assert deep["duration_source"] == "torch_profiler_trace"
    common = get_common_metrics(deep, ncu_data=deep)
    assert common["kernels_profiled"] == ["gauss_window_rows<gip::Weighted, 3>"]
    assert common["dram_throughput_pct"] == mem["DRAM Throughput (% of peak)"]
    assert common["peak_device_memory_bytes"] == 41_709_568
    assert "occupancy_pct" not in common
    # No tensor-core work at level 2.
    assert not any("Tensor Core" in k for k in deep["execution"])


def test_unknown_card_gets_no_percentages(monkeypatch):
    deep = _card_profile(monkeypatch, "NVIDIA A100-SXM4-80GB")
    assert "DRAM Throughput (% of peak)" not in deep["memory"]
    assert "no trusted peak table" in deep["config"]["Peak Table"]


def test_band_reports_modeled_tensor_core_throughput(monkeypatch):
    deep = _card_profile(monkeypatch, H100, level=4, radius=15)
    flops = deep["config"]["Modeled Tensor Core FLOPs"]
    assert flops == traffic.band_mma_flops(2146, 3239, 3, 15)
    assert deep["execution"]["Tensor Core Throughput (% of bf16 peak, modeled)"] \
        == pytest.approx(100.0 * flops / 0.07e-3 / 989e12)


def test_io_bytes_floor():
    assert traffic.io_bytes(2146, 3239, 3) == 2 * 2146 * 3239 * 3
    assert traffic.io_bytes(4, 10, 12, 3) == 2 * 4 * 10 * 12 * 3


def test_band_flops_follow_the_kernel_tiles():
    # One 16 x 16 output tile at r = 3, C = 1: horizontal depth 16 + 6 -> 32
    # (2 steps), vertical the same; the horizontal band also covers the
    # halo rows: 1 - 1 + 32 / 16 = 2 row tiles.  Hi and lo products.
    mmas = 2 * (2 * 1 * 2 + 1 * 1 * 2)
    assert traffic.band_mma_flops(16, 16, 1, 3) == mmas * 2 * 16 ** 3
    assert traffic.band_mma_flops(16, 16, 1, 3, batch=5) == 5 * mmas * 2 * 16 ** 3
    # A 64 x 128 tile is one block; twice the lanes, twice the work.
    one = traffic.band_mma_flops(64, 128, 1, 7)
    assert traffic.band_mma_flops(64, 256, 1, 7) == 2 * one


@pytest.mark.parametrize("filt,level,radius", [
    ("gaussian", 2, 3), ("gaussian", 4, GAUSS_MXU_MIN_RADIUS - 1), ("gaussian", 1, 15),
    ("box", 2, 5), ("box", 4, 5), ("sobel", 2, None), ("sobel", 4, None)])
def test_no_tensor_core_work_off_the_band(filt, level, radius):
    """The JAX model (served_mxu_flops) also counts matrix-unit work for
    box and Sobel, which the TPU ran on its matrix unit; the port's box and
    Sobel kernels run on the CUDA cores, and level 4 below
    GAUSS_MXU_MIN_RADIUS folds its taps, so no route but the band issues
    tensor-core work."""
    assert traffic.served_tensor_core_flops(filt, level, 64, 64, 3, radius) is None


def test_band_route_issues_tensor_core_work():
    flops = traffic.served_tensor_core_flops("gaussian", 4, 64, 64, 3,
                                             GAUSS_MXU_MIN_RADIUS)
    assert flops == traffic.band_mma_flops(64, 64, 3, GAUSS_MXU_MIN_RADIUS) > 0


#: Keys of the JAX package's profile that the port's has not, and why.
NOT_PORTED = {
    # Categorized dict: every port kernel runs both passes in one launch.
    "per_pass_durations_ms": "no launch boundary between the passes",
    # Flattened keys: on the CPU the JAX package reports XLA's static buffer
    # analysis; the port reads device memory only on the card.
    "peak_device_memory_bytes": "no device memory to read on the CPU",
}
#: Keys of the port's profile that the JAX package's has not.
ADDED = {"bytes_source"}


@pytest.mark.parametrize("filt,level,sigma,radius", CASES)
def test_keys_match_the_jax_profiler(rng, cpu, monkeypatch, filt, level, sigma,
                                     radius):
    """The same CPU call with no peak table on either side."""
    monkeypatch.setenv("GIP_TPU_TEST_PEAKS", "0")
    img = make_image(rng, 12, 15, 3)
    got = profile_filter(cpu, img, filt, level, sigma=sigma, radius=radius)
    want = jax_profiler.profile_filter(img, filt, level, sigma=sigma, radius=radius)
    assert set(got) - ADDED == set(want) - set(NOT_PORTED)
    for section in ("execution", "memory", "config"):
        assert section in got and section in want
    common = set(get_common_metrics(got, ncu_data=got))
    want_common = set(jax_profiler.get_common_metrics(want, ncu_data=want))
    assert common == want_common - set(NOT_PORTED)
    assert got["config"]["Image Shape"] == want["config"]["Image Shape"]


def test_capture_trace_writes_a_chrome_trace(rng, cpu, tmp_path):
    img = make_image(rng, 8, 9, 3)
    out = profiler.capture_trace(lambda: cpu.run("box", img, level=2, radius=2),
                                 "cpu", str(tmp_path))
    assert out == str(tmp_path)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.cuda
def test_card_profile_lists_the_hand_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    rt = FilterRuntime("cuda")
    img = make_image(np.random.default_rng(0), 512, 640, 3)
    _, metrics = rt.run("gaussian", img, level=2, sigma=2.0, radius=3)
    deep = profile_filter(rt, img, "gaussian", 2, sigma=2.0, radius=3)
    assert deep["duration_source"] == "torch_profiler_trace"
    assert all("gauss_window_rows" in k for k in deep["kernels_profiled"])
    assert deep["memory"]["Peak Device Memory (bytes)"] >= 2 * img.size
    assert deep["total_kernel_duration_ms"] == pytest.approx(metrics.time_ms, rel=0.3)


#: The kernel a trace names for each wrapper's launch at the radii below.
TRACE_NAMES = {
    "gaussian_rows": "gauss_window_rows<gip::Weighted",
    "gaussian_folded_rows": "gauss_window_rows<gip::Folded",
    "box_rows": "gauss_window_rows<gip::Box",
    "gaussian_band_rows": "band_mma_rows",
    "sobel_rows": "sobel_tile_rows<true",
    "sobel_f32_rows": "sobel_tile_rows<false",
}


@pytest.mark.cuda
def test_card_traces_keep_every_launch_late_in_a_process():
    """After 204 profiled requests, each profile and then a profile of the
    model's forward hold every launch of every hand kernel: for each, the
    trace's count equals the LAUNCHES delta of the traced runs (of the
    session that was rated, `Trace Sessions` counting those opened)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    from collections import Counter

    from gpu_image_processing_tpu_torch.models import GaussianBlur
    from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES

    rt = FilterRuntime("cuda")
    img = make_image(np.random.default_rng(0), 512, 640, 3)
    cases = [("gaussian", 2, 2.0, 3), ("box", 2, None, 5), ("sobel", 2, None, None),
             ("gaussian", 4, 2.0, 2), ("gaussian", 4, 2.0, 5), ("sobel", 4, None, None)]

    def by_wrapper(stats) -> dict[str, int]:
        counts: Counter = Counter()
        for name, row in stats.items():
            short = profiler.short_kernel_name(name)
            for key, prefix in TRACE_NAMES.items():
                if short.startswith(prefix):
                    counts[key] += row["count"]
        return dict(counts)

    reps = profiler.PROFILE_REPS
    reopened = 0
    for i in range(204):
        filt, level, sigma, radius = cases[i % len(cases)]
        before = Counter(LAUNCHES)
        try:
            deep = profile_filter(rt, img, filt, level, sigma=sigma,
                                  radius=radius)
        except RuntimeError as exc:
            raise AssertionError(f"profile {i}, {filt} L{level}: {exc}") from exc
        made = Counter(LAUNCHES) - before
        # The untimed first run, then the traced runs of each session.
        runs = 1 + reps * deep["config"]["Trace Sessions"]
        reopened += deep["config"]["Trace Sessions"] > 1
        assert by_wrapper(deep["trace_kernel_stats"]) == {
            key: n // runs * reps for key, n in made.items()}, (i, made)
    # The sessions' primers and lead, not their second chance, keep the
    # launches: 0 to 1 profile in 200 lost one on the card (PERF.md).
    assert reopened <= 3
    model = GaussianBlur(2.0, 3, 2).to(rt.device)
    x = torch.from_numpy(img).to(rt.device)
    model(x)
    before = Counter(LAUNCHES)
    _, kernels, _, account = profiler._measure((rt.device,), lambda: model(x),
                                               reps)
    made = Counter(LAUNCHES) - before
    assert made == {"gaussian_rows": reps * account["Trace Sessions"]}
    assert by_wrapper(kernels) == {"gaussian_rows": reps}


def test_short_kernel_names_label_the_execution_rows(monkeypatch):
    assert profiler.short_kernel_name(
        "void (anonymous namespace)::gauss_window_rows<gip::Weighted, 3>("
        "unsigned char const*, unsigned char*, (anonymous namespace)::GaussTaps, "
        "int)") == "gauss_window_rows<gip::Weighted, 3>"
    assert profiler.short_kernel_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    long = "void at::native::vectorized_elementwise_kernel<4, " + "x" * 80 + ">(int)"
    assert len(profiler.short_kernel_name(long)) == 70
    deep = _card_profile(monkeypatch, H100)
    assert "Duration gauss_window_rows<gip::Weighted, 3> (ms)" in deep["execution"]


class _Row:
    def __init__(self, key, count, device_us, device_type):
        self.key, self.count = key, count
        self.device_time_total, self.device_type = device_us, device_type


def test_trace_rows_count_each_call_once_a_launch():
    """A row's time a call is its device time over the calls (a launch the
    trace missed is not made up for: `check_launches` refuses such a
    trace); host rows, rows without device time and the session's primers
    are left out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    averages = [
        _Row("one a call", 4, 280.0, cuda),
        _Row("fourteen a call", 56, 1120.0, cuda),
        _Row("aten::add", 4, 300.0, cpu),
        _Row("idle", 4, 0.0, cuda),
        _Row("spin_kernel(long)", 12, 30.0, cuda)]
    rows = profiler._trace_kernels(averages, reps=4)
    assert profiler.primers_kept(averages) == 12
    assert set(rows) == {"one a call", "fourteen a call"}
    assert rows["one a call"]["per_call_ms"] == pytest.approx(0.07)
    assert rows["fourteen a call"]["per_call_ms"] == pytest.approx(0.02 * 14)
    assert rows["fourteen a call"]["avg_ms"] == pytest.approx(0.02)


GAUSS_ROW = ("void (anonymous namespace)::gauss_window_rows<gip::Weighted, 3>"
             "(unsigned char const*, unsigned char*, int)")
COPY_ROW = "Memcpy DtoD (Device -> Device)"


def _rows(counts: dict[str, int]) -> dict[str, dict[str, float]]:
    """Trace rows (`_trace_kernels`) of the given launch counts."""
    return {name: {"count": n, "total_ms": 0.07 * n, "avg_ms": 0.07,
                   "per_call_ms": 0.07 * n / 10} for name, n in counts.items()}


@pytest.mark.parametrize("rows,made", [
    ({GAUSS_ROW: 10, COPY_ROW: 20}, 10),
    ({"box_wide_h(unsigned char const*)": 10,
      "box_wide_v(unsigned char const*)": 10}, 10),
    ({"sobel_tile_rows<true, 3, false>(int)": 4,
      "band_mma_rows(int)": 4, "box_window_rows(int)": 2}, 10),
    ({COPY_ROW: 4}, 0),
])
def test_a_trace_with_every_launch_is_rated(rows, made):
    profiler.check_launches(_rows(rows), made)


@pytest.mark.parametrize("rows,made,traced", [
    ({GAUSS_ROW: 8, COPY_ROW: 20}, 10, 8),
    ({COPY_ROW: 20}, 10, 0),
    ({"box_wide_h(unsigned char const*)": 10,
      "box_wide_v(unsigned char const*)": 9}, 10, 10),
])
def test_a_trace_that_lost_launches_is_refused(rows, made, traced):
    """The trace's count and LAUNCHES' both stand in the error, which the
    server answers as `profiling_error` (test_torch_server.py)."""
    with pytest.raises(RuntimeError, match=(
            f"the trace holds {traced} hand-kernel launches where {made} "
            f"were made")):
        profiler.check_launches(_rows(rows), made)


def test_a_session_that_lost_launches_is_opened_again(monkeypatch):
    """On the card a profile opens another session, with twice the lead and
    four times the primers, while its trace misses a launch,
    `SESSION_ATTEMPTS` at most, and reports how many it took."""
    card = (torch.device("cuda", 0),)
    sessions = []

    def session(devices, run, reps, lead_s, primers):
        sessions.append((lead_s, primers))
        lost = len(sessions) < 3
        return _rows({GAUSS_ROW: 9 if lost else 10}), 10, 1 << 20, 16

    monkeypatch.setattr(profiler, "_session", session)
    times, kernels, peak, account = profiler._measure(card, lambda: None, 10)
    assert len(sessions) == 3 and kernels[GAUSS_ROW]["count"] == 10
    assert sessions == [(profiler.SESSION_LEAD_S * k, profiler.PRIMERS * k * k)
                        for k in (1, 2, 4)]
    assert account == {"Trace Sessions": 3, "Trace Primers Kept": "16 of 256"}
    assert times == [pytest.approx(0.07)] * 10 and peak == 1 << 20
    sessions.clear()
    monkeypatch.setattr(profiler, "SESSION_ATTEMPTS", 2)
    with pytest.raises(profiler.LostLaunches, match=(
            "9 hand-kernel launches where 10 were made .*, in each of 2 "
            "sessions \\(the last with a 40 ms lead, 16 of 64 primers kept\\)")):
        profiler._measure(card, lambda: None, 10)
    assert len(sessions) == 2
