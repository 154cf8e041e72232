"""tools/sol_report.py and the bound model it shares with chip_smoke.py
(profiling/traffic.py): the op entries' sanity rules and the --check gate,
as tests/test_sol_traffic.py holds the JAX report's, for the port's rows;
the bounds of PERF.md section 5 at 2146x3239x3."""

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu_torch.profiling.profiler import PEAKS
from gpu_image_processing_tpu_torch.profiling.traffic import (
    band_mma_flops, io_bytes, kernel_operations, least_ms, operations_rate)
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.tools import sol_report as sol

H100 = PEAKS["NVIDIA H100 80GB HBM3"]
FULL = (2146, 3239, 3)
GAUSS_ROWS = "void (anonymous namespace)::gauss_window_rows<gip::Weighted, 3>(GaussTaps)"
BOX_ROWS = "void (anonymous namespace)::gauss_window_rows<gip::Box, 5>(int)"
BAND = "void (anonymous namespace)::band_mma_rows(unsigned char const*)"
SOBEL = "void (anonymous namespace)::sobel_tile_rows<true, 3, false>(int)"
TORCH = "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel>(int)"


def _rec(avg_ms, count=10, reps=10):
    return {"avg_ms": avg_ms, "count": count, "total_ms": avg_ms * count,
            "per_call_ms": avg_ms * max(1, round(count / reps))}


# -- the bound model (chip_smoke.py::bound reads it) ---------------------------

@pytest.mark.parametrize("radius, want, by", [
    (1, 0.0124, "bytes"), (3, 0.0175, "operations"),
    (15, 0.0773, "operations"), (20, 0.1022, "operations"),
    (31, 0.1571, "operations")])
def test_gaussian_bounds_of_section_5(radius, want, by):
    ms, got_by = least_ms("gaussian_rows", FULL, radius, H100)
    assert round(ms, 4) == want and got_by == by


@pytest.mark.parametrize("name", ["box_rows", "sobel_rows", "sobel_f32_rows",
                                  "gaussian_band_rows", "box_planar",
                                  "sobel_planar"])
def test_bytes_bound_kernels(name):
    ms, by = least_ms(name, FULL, 3 if "band" in name else 5, H100)
    assert round(ms, 4) == 0.0124 and by == "bytes"
    assert ms == pytest.approx(io_bytes(*FULL) / H100.hbm_bytes_per_s * 1e3)


def test_operation_counts():
    elems = int(np.prod(FULL))
    assert kernel_operations("gaussian_rows", FULL, 3) == 2 * 14 * elems
    assert kernel_operations("gaussian_folded_rows", FULL, 2) == 2 * 8 * elems
    assert kernel_operations("gaussian_band_rows", FULL, 3) == 2 * 29 * elems
    assert kernel_operations("box_rows", FULL, 4000) == 2 * 4 * elems
    assert kernel_operations("sobel_rows", FULL, 1) == 35 * elems // 3
    assert operations_rate("gaussian_band_rows", H100) == H100.bf16_tensor_ops_per_s
    assert operations_rate("box_rows", H100) == H100.f32_ops_per_s


def test_chip_smoke_bound_is_the_package_model():
    import chip_smoke

    for name in chip_smoke.KERNELS:
        for radius in (1, 3, 15):
            assert chip_smoke.bound(name, FULL, radius) == least_ms(
                name, FULL, radius, H100)


# -- op entries ----------------------------------------------------------------

def test_op_entry_sub_resolution_rate_suppressed():
    model = sol.kernel_model("gaussian_rows", "gaussian", 2, FULL, 3)
    e = sol.make_op_entry(GAUSS_ROWS, _rec(0.001), 0.01, H100, model)
    assert e["sol_note"] == "sub-resolution"
    assert e["gbps"] is None and e["sol_pct"] is None and e["pct_of_bound"] is None
    assert e["implied_gbps"] > 0     # kept for forensics, not as a claim


def test_op_entry_exceeds_peak_flagged_not_printed():
    # 41.7 MB in 0.01 ms would be 4.2 TB/s on a 3.35 TB/s part.
    model = sol.kernel_model("box_rows", "box", 2, FULL, 5)
    e = sol.make_op_entry(BOX_ROWS, _rec(0.01), 0.01, H100, model)
    assert e["sol_note"] == "exceeds-peak"
    assert e["sol_pct"] is None and e["gbps"] is None and e["bound"] is None
    assert 4000 < e["implied_gbps"] < 4300


def test_op_entry_normal_rate_passes_through():
    # gaussian_rows r=3 at section 5's 0.0692 ms: 25.2% of its bound, by
    # operations.
    model = sol.kernel_model("gaussian_rows", "gaussian", 2, FULL, 3)
    e = sol.make_op_entry(GAUSS_ROWS, _rec(0.0692), 0.0692, H100, model)
    assert e["kernel"] == "gaussian_rows" and e["share_pct"] == pytest.approx(100)
    assert e["bound"] == "operations"
    assert e["pct_of_bound"] == pytest.approx(100 * 0.017453 / 0.0692, rel=1e-3)
    assert e["sol_pct"] == pytest.approx(100 * 0.012449 / 0.0692, rel=1e-3)
    assert e["bound_ms"] == pytest.approx(0.017453, rel=1e-3)
    assert "sol_note" not in e


def test_op_entry_band_dual_roofline():
    # The band's compute roofline is the tensor-core FLOPs it issues against
    # the bf16 peak; its bytes bind at r = 3.
    model = sol.kernel_model("gaussian_band_rows", "gaussian", 4, FULL, 3)
    flops = band_mma_flops(*FULL, 3)
    assert model == {"bytes": io_bytes(*FULL), "operations": flops,
                     "rate": "bf16_tensor"}
    e = sol.make_op_entry(BAND, _rec(0.1495), 0.1495, H100, model)
    assert e["sol_pct_ops"] == pytest.approx(
        100 * flops / (0.1495e-3) / H100.bf16_tensor_ops_per_s)
    assert e["bound"] == "bytes" and e["pct_of_bound"] == e["sol_pct"]
    assert 8.0 < e["pct_of_bound"] < 8.7
    # Below the band's radius the level-4 gaussian runs folded taps, on the
    # float32 rate.
    assert sol.kernel_model("gaussian_folded_rows", "gaussian", 4, FULL,
                            2)["rate"] == "f32"


def test_op_entry_torch_row_gets_no_model():
    e = sol.make_op_entry(TORCH, _rec(0.07, count=140), 2.6, H100)
    assert e["kernel"] is None and e["bytes"] is None
    assert e["launches"] == 140 and e["per_call_ms"] == pytest.approx(0.98)


def test_op_entry_without_peaks_gives_rates_only():
    model = sol.kernel_model("sobel_rows", "sobel", 2, FULL, 1)
    e = sol.make_op_entry(SOBEL, _rec(0.0375), 0.0375, None, model)
    assert e["gbps"] == pytest.approx(io_bytes(*FULL) / 0.0375e-3 / 1e9)
    assert e["sol_pct"] is None and e["pct_of_bound"] is None


@pytest.mark.parametrize("name, kernel", [
    (GAUSS_ROWS, "gaussian_rows"), (BOX_ROWS, "box_rows"),
    (BAND, "gaussian_band_rows"), (SOBEL, "sobel_rows"),
    ("void gauss_window_rows<gip::Folded, 2>(x)", "gaussian_folded_rows"),
    ("void box_window_rows<3>(x)", "box_rows"), ("void box_wide_h(x)", "box_rows"),
    ("void sobel_tile_rows<false, 4, false>(x)", "sobel_f32_rows"),
    (TORCH, None)])
def test_hand_kernel_names(name, kernel):
    assert sol.hand_kernel(name) == kernel


# -- the --check gate ----------------------------------------------------------

def _payload(level, *ops, source="torch_profiler_trace"):
    return {"peaks": H100._asdict(), "rows": [
        {"filter": "gaussian", "level": level, "duration_source": source,
         "ops": list(ops)}]}


def _entry(name, avg, total, model=None):
    return sol.make_op_entry(name, _rec(avg), total, H100, model)


def test_check_passes_a_sound_row():
    model = sol.kernel_model("gaussian_rows", "gaussian", 2, FULL, 3)
    assert sol.check(_payload(2, _entry(GAUSS_ROWS, 0.0692, 0.0692, model))) == []


def test_check_flags_dominant_hand_kernel_without_bytes():
    payload = _payload(2, _entry(GAUSS_ROWS, 0.0692, 0.0700),
                       _entry(TORCH, 0.0008, 0.0700))
    problems = sol.check(payload)
    assert len(problems) == 1 and "bytes=null" in problems[0]


def test_check_flags_shares_over_100():
    model = sol.kernel_model("gaussian_rows", "gaussian", 2, FULL, 3)
    payload = _payload(2, _entry(GAUSS_ROWS, 0.0692, 0.0692, model),
                       _entry(TORCH, 0.04, 0.0692))
    assert any("shares sum" in p for p in sol.check(payload))


def test_check_flags_modeled_rate_past_peak():
    model = sol.kernel_model("box_rows", "box", 2, FULL, 5)
    payload = _payload(2, _entry(BOX_ROWS, 0.01, 0.01, model))
    assert any("past peak" in p for p in sol.check(payload))


def test_check_flags_printed_impossible_percentage():
    model = sol.kernel_model("gaussian_rows", "gaussian", 2, FULL, 3)
    entry = _entry(GAUSS_ROWS, 0.0692, 0.0692, model)
    entry["pct_of_bound"] = 167.9
    assert any("impossible" in p for p in sol.check(_payload(2, entry)))


def test_check_flags_a_kernel_row_that_lost_its_hand_kernel():
    payload = _payload(4, _entry(TORCH, 0.07, 0.07))
    assert any("no hand kernel" in p for p in sol.check(payload))


def test_check_does_not_gate_level_1_rows():
    # Level 1: plain torch elementwise kernels, no bytes in the trace.
    payload = _payload(1, _entry(TORCH, 0.9, 2.6), _entry(TORCH, 1.7, 2.6))
    assert sol.check(payload) == []


def test_check_skips_rows_without_a_trace():
    payload = _payload(2, source="wall_timing")
    assert sol.check(payload) == []


def test_build_report_on_the_cpu_has_no_table():
    rt = FilterRuntime("cpu")
    img = np.random.default_rng(0).integers(0, 256, (40, 52, 3), np.uint8)
    payload = sol.build_report(rt, img, levels=(2,))
    assert [r["filter"] for r in payload["rows"]] == ["gaussian", "box", "sobel"]
    assert all(r["duration_source"] == "wall_timing" and r["ops"] == []
               for r in payload["rows"])
    assert payload["peaks"] is None and payload["device"]["platform"] == "cpu"
    assert sol.check(payload) == []


def test_raises_without_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sol.main(["--out-dir", str(tmp_path)])
