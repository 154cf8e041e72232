"""What `BENCHMARK.json` says of one cell, and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric is a file found by its name: `configs/<config>.json`,
`traffic/<mix>.json`, `end_to_end/<metric>.py` and `metrics/<metric>.py`.
Adding a cell, a configuration, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    #: The metrics this cell reports, in BENCHMARK.json's order, each with
    #: its entry and its reader.
    end_to_end: list[tuple[dict, ModuleType]]
    per_layer: list[tuple[dict, ModuleType]]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(kind: str, name: str, bench_dir: Path = BENCH_DIR
                ) -> ModuleType:
    """The reader module `<kind>/<name>.py`, which defines `read(obs)`."""
    if not NAME.match(name):
        raise ValueError(f"metric name {name!r} is not a name")
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cells(root: Path = ROOT) -> list[str]:
    """The cells `BENCHMARK.json` at `root` names."""
    return [w["name"] for w in _json(root / "BENCHMARK.json")["workloads"]]


def load(cell_name: str, root: Path = ROOT) -> Cell:
    """Cell `cell_name` of `root/BENCHMARK.json`, with its files."""
    bench = _json(root / "BENCHMARK.json")
    bench_dir = root / Path(bench["paths"][0])
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise KeyError(f"no cell {cell_name!r}; the cells are "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Cell(
        name=cell_name, chips=int(cell["chips"]),
        config=_json(root / conf["file"]),
        mix=_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=[(m, load_reader("end_to_end", m["name"], bench_dir))
                    for m in bench["end_to_end"] if _reports(m, cell_name)],
        per_layer=[(m, load_reader("metrics", m["name"], bench_dir))
                   for m in bench["per_layer"] if _reports(m, cell_name)])
