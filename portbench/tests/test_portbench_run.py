"""The harness end to end on the CPU at small sizes: a sound run is
correct; the control and every planted fault a cell can have come out
not correct; without a card, or without the program, no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import chip, control, entries, runner

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"ui_photo.process_all_png": {"sizes": [[40, 56]]},
         "lib_photo.api_repeat": {"sizes": [[40, 56]]},
         "lib_photo.forward_frames": {"sizes": [[40, 56]]}}
SMALL_SCENE = {"scene": {"height": 40, "width": 56}}
SEED = 2**33 + 17


def _run(cell: str, alter=None, seconds: float = 0.4) -> dict:
    return runner.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                           device="cpu", alter=alter,
                           mix_overrides=CELLS[cell],
                           config_overrides=SMALL_SCENE)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checked"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checked"
    assert {"setup_s"} < set(result["metrics"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell):
    result = _run(cell, control.control)
    assert not result["correct"]
    assert result["checked"]["exact_bytes_off"][0] > 0


FAULTS = [(cell, fault) for cell in sorted(CELLS)
          for fault in ("unchanged", "altered")]
FAULTS.append(("ui_photo.process_all_png", "dropped_level"))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    result = _run(cell, control.FAULTS[fault])
    assert not result["correct"], result["checked"]


def test_a_module_of_jax_loaded_by_the_window_refuses_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    with pytest.raises(chip.Forbidden):
        _run("lib_photo.api_repeat", seconds=0.1)


@pytest.mark.parametrize("step", ["release", "check"])
def test_a_module_of_jax_loaded_after_the_window_refuses_the_run(
        monkeypatch, step):
    """The program's release and the check run after the window closes;
    a module they load still refuses the result."""
    original = getattr(entries.ApiEntry, step)

    def loading(self, *args):
        monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
        return original(self, *args)

    monkeypatch.setattr(entries.ApiEntry, step, loading)
    with pytest.raises(chip.Forbidden, match="jaxlib"):
        _run("lib_photo.api_repeat", seconds=0.1)


def test_a_reply_without_a_promised_level_is_unreadable():
    result = _run("ui_photo.process_all_png", control.FAULTS["dropped_level"])
    value, limit = result["checked"]["unreadable_answers"]
    assert value > 0 and limit == 0 and result["failed"] == 0


def test_the_port_is_not_forbidden(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpu_image_processing_tpu_torch.x", sys)
    assert chip.forbidden_modules() == []


def _cli(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "lib_photo.api_repeat", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_without_a_card_no_result(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    proc = _cli(ROOT)
    assert proc.returncode != 0
    assert "is_available() is false" in proc.stderr
    assert not proc.stdout.strip()


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or "correct" not in lines[-1]


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    """On the card: one short run of the forward cell from the command
    line, its last line the contract's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "lib_photo.forward_frames", "--seed", str(2**31 + 11), "--seconds",
         "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["kernels_roofline"]["value"] <= 100


def test_a_run_with_the_span_recorder_takes_the_overrides():
    """`run_spans.py`'s path: the recorder on, the cell loaded with its
    metrics of `program_spans.json` and the overrides, the counters with
    the recorder's totals."""
    from portbench.harness import program_spans

    try:
        with program_spans.recording():
            result = _run("lib_photo.api_repeat", seconds=0.3)
    except program_spans.NoRecorder:
        pytest.skip("the port has no span recorder")
    assert result["correct"], result["checked"]
    assert "exec.stage_ms_per_call" in result["metrics"]
