"""What `BENCHMARK.json` says of one cell, and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric is a file found by its name: `configs/<config>.json`,
`traffic/<mix>.json`, `end_to_end/<metric>.py` and `metrics/<metric>.py`.
Adding a cell, a configuration, a mix or a metric adds files and entries
and edits none.  A mix is checked when it is loaded (`check_mix`): what a
template or an upload may say, and what the configuration has to state
for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

from ..reference import jpeg

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEMPLATE_KEYS = {"filter", "level", "sigma", "radius"}
JPEG_KEYS = {"format", "quality", "subsampling", "exif"}


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


def check_mix(mix: dict, config: dict) -> None:
    """Raise ValueError where mix `mix` cannot run on configuration
    `config`.

    A call template names a filter of the configuration and may carry a
    level, a `sigma` and a `radius`.  The optional `upload` of an `http`
    mix, `{"format": "jpeg", "quality": q, "subsampling": "4:2:0" or
    "4:4:4", "exif": true}`, makes the uploads JPEGs (without it they are
    PNGs); it needs `exif: true`, since the server passes a JPEG without
    rendering metadata through as the original, and the configuration's
    stated decode tolerance, `numerics.within_tolerance.jpeg_decode`."""
    for i, t in enumerate(mix["calls"]):
        if set(t) - TEMPLATE_KEYS or t.get("filter") not in config["filters"]:
            raise ValueError(
                f"call template {i} {t}: a template names a filter of "
                f"{sorted(config['filters'])} and may carry only "
                f"{sorted(TEMPLATE_KEYS - {'filter'})}")
    up = mix.get("upload")
    if up is None:
        return
    if mix.get("entry") != "http":
        raise ValueError(f"an `upload` in a mix of entry {mix.get('entry')!r}:"
                         " only the http entry uploads")
    if (up.get("format") != "jpeg" or set(up) != JPEG_KEYS
            or up["subsampling"] not in jpeg.SUBSAMPLING
            or not isinstance(up["quality"], int)
            or not 1 <= up["quality"] <= 100):
        raise ValueError(
            f"upload {up}: an upload is {{\"format\": \"jpeg\", \"quality\": "
            f"1..100, \"subsampling\": one of {sorted(jpeg.SUBSAMPLING)}, "
            f"\"exif\": true}}; without it the uploads are PNGs")
    if up["exif"] is not True:
        raise ValueError(
            "a JPEG upload without `exif: true`: the server passes a JPEG "
            "whose headers are all rendering-neutral through as the "
            "original, so its reply would not show what the program "
            "decoded")
    tol = config["numerics"]["within_tolerance"].get("jpeg_decode", {})
    if not {"max_diff", "max_share_pct"} <= set(tol):
        raise ValueError(
            "a JPEG upload on a configuration that states no "
            "`numerics.within_tolerance.jpeg_decode` {max_diff, "
            "max_share_pct}: the server's decode is held to the reference "
            "decode within a stated tolerance")


def load(cell_name: str, root: Path = ROOT, mix_overrides: dict | None = None,
         config_overrides: dict | None = None) -> Cell:
    """Cell `cell_name` of `root/BENCHMARK.json`, with its files, its mix
    and configuration updated by the overrides (the tests' small sizes)
    and checked."""
    bench = _json(root / "BENCHMARK.json")
    bench_dir = root / Path(bench["paths"][0])
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise KeyError(f"no cell {cell_name!r}; the cells are "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = {**_json(root / conf["file"]), **(config_overrides or {})}
    mix = {**_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
           **(mix_overrides or {})}
    check_mix(mix, config)
    return Cell(
        name=cell_name, chips=int(cell["chips"]), config=config, mix=mix,
        end_to_end=[(m, load_reader("end_to_end", m["name"], bench_dir))
                    for m in bench["end_to_end"] if _reports(m, cell_name)],
        per_layer=[(m, load_reader("metrics", m["name"], bench_dir))
                   for m in bench["per_layer"] if _reports(m, cell_name)])
