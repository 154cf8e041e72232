"""`BENCHMARK.json` against the contract's shape, and the harness driven by
data: a cell, a configuration, a mix and a metric added as files and
entries are found by name, with no edit to a file that is there."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

from portbench.harness import runner, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CHECK_BUDGET_S = 43200


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_top_level_keys_and_the_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= CHECK_BUDGET_S


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert spec.NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] == 1
        assert spec.NAME.match(w["traffic"]) and spec.NAME.match(w["config"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_names_files_and_metrics_that_exist():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["entry"] in ("http", "api", "forward")
        names = [m["name"] for m, _ in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m, reader in cell.end_to_end + cell.per_layer:
            assert callable(reader.read), m["name"]
        for m, _ in cell.per_layer:
            moved = e2e[m["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]])
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_each_per_layer_metric_has_one_layer_name_a_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"Codec", "Runtime", "HTTP", "Device",
                           "Executables", "Kernels"}


NEW_CONFIG = {"name": "lib_tiles", "source": "https://example.org/tiles",
              "reduced": []}


@pytest.fixture
def grown(tmp_path):
    """A copy of the benchmark with a configuration, a mix, a per-layer
    metric and a cell added as new files and entries."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/lib_photo.json").read_text())
    cfg.update(NEW_CONFIG, scene={"height": 24, "width": 40})
    (tmp_path / "portbench/configs/lib_tiles.json").write_text(json.dumps(cfg))
    mix = {"entry": "api", "sizes": [[24, 40]], "pool": 2, "sample": 4,
           "calls": [{"filter": "box", "level": 2}]}
    (tmp_path / "portbench/traffic/box_tiles.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/calls.count.py").write_text(
        "def read(obs):\n    return float(len(obs['calls']))\n")
    bench["configs"].append({**NEW_CONFIG, "file":
                             "portbench/configs/lib_tiles.json", "why": "x"})
    bench["workloads"].append({"name": "lib_tiles.box", "config": "lib_tiles",
                               "traffic": "box_tiles", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("lib_tiles.box")
    bench["per_layer"].append({"name": "calls.count", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "Runtime", "moves": "images_per_s",
                               "workloads": ["lib_tiles.box"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_cell_added_as_files_is_found_with_no_edit(grown):
    assert "lib_tiles.box" in spec.cells(grown)
    cell = spec.load("lib_tiles.box", grown)
    assert cell.config["name"] == "lib_tiles"
    assert [m["name"] for m, _ in cell.per_layer] == ["calls.count"]
    for name in spec.cells(ROOT):
        assert spec.load(name, grown).mix == spec.load(name, ROOT).mix


def test_a_cell_added_as_files_runs(grown):
    result = runner.run_cell("lib_tiles.box", 2**40 + 3, 0.3, False,
                             time.perf_counter(), device="cpu", root=grown)
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"images_per_s", "setup_s"}
