"""What the verification tools share: the numpy oracle and its worker pool,
the failure count, the output directory, the device argument.

The tools (`validation.py`, `soak.py`, `sol_report.py`, `silicon_ci.py`)
are the port's counterparts of the JAX system's on-silicon tier
(`scripts/tpu_validation.py`, `soak_fuzz.py`, `sol_report.py`,
`silicon_ci.py`).  Each runs on the card unless asked for the CPU with
`--device cpu`, and writes one JSON report into `OUT_DIR`, `silicon_out/`
in the working directory (listed in the repository's `.gitignore`), or the
directory given with `--out-dir`; never into the package.

The oracle is the repository's independent numpy oracle of the reference's
semantics, `tests/oracle_numpy.py`: test code, not code of the port, which
no wheel carries, so the tools that need it are checkout tools.  It is
loaded from the checkout when a tool runs, never when a module is imported.
Its Sobel loops over the pixels in Python (about 20 us a pixel), so the
tools hand each oracle call to an `OraclePool` of worker processes while
the card computes the next case; `workers=0` evaluates it in the calling
process.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import multiprocessing
import os
from concurrent.futures import Future, ProcessPoolExecutor
from pathlib import Path
from types import ModuleType
from typing import Any

from ..core.files import repo_file

ORACLE = "tests/oracle_numpy.py"
#: Where the tools write their JSON reports unless given --out-dir.
OUT_DIR = Path("silicon_out")


@functools.cache
def load_oracle() -> ModuleType:
    """`tests/oracle_numpy.py` of this checkout, loaded once a process;
    raises naming it outside a checkout."""
    path = repo_file(ORACLE, "the numpy oracle of the verification tools")
    spec = importlib.util.spec_from_file_location("oracle_numpy", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def call_oracle(fn_name: str, *args: Any) -> Any:
    """`oracle_numpy.<fn_name>(*args)`: the function a worker runs."""
    return getattr(load_oracle(), fn_name)(*args)


class OraclePool:
    """Oracle calls in `workers` spawned processes (numpy only: they touch
    no card), or in this process when `workers` is 0."""

    def __init__(self, workers: int):
        load_oracle()   # fail here, not in a worker, if it is missing
        self._pool = (ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
            if workers > 0 else None)

    def submit(self, fn_name: str, *args: Any) -> Future:
        if self._pool is not None:
            return self._pool.submit(call_oracle, fn_name, *args)
        done: Future = Future()
        done.set_result(call_oracle(fn_name, *args))
        return done

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)

    def __enter__(self) -> "OraclePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Checks:
    """Each check's line, printed as it is made, and the failures."""

    def __init__(self) -> None:
        self.records: list[dict[str, Any]] = []
        self.failures = 0

    def __call__(self, label: str, ok: bool, detail: str = "") -> bool:
        ok = bool(ok)
        self.failures += not ok
        self.records.append({"check": label, "ok": ok, "detail": detail})
        print(f"{label}: {'OK' if ok else 'MISMATCH'}"
              + (f" ({detail})" if detail else ""), flush=True)
        return ok


def maxdiff(a, b) -> int:
    """Largest absolute difference of two uint8 arrays."""
    import numpy as np

    if a.shape != b.shape:
        return 256
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max(initial=0))


def diff_fraction(a, b) -> float:
    """Share of the values of two uint8 arrays that differ."""
    return float((a != b).mean()) if a.size else 0.0


def common_arguments(parser: argparse.ArgumentParser,
                     workers: bool = True) -> None:
    """--device, --out-dir and (oracle tools) --workers."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the filters run")
    parser.add_argument("--out-dir", default=str(OUT_DIR),
                        help="directory of the JSON report")
    if workers:
        parser.add_argument(
            "--workers", type=int, default=os.cpu_count() or 1,
            help="oracle worker processes (0: in this process)")


def write_report(out_dir: str, name: str, payload: dict) -> Path:
    """`payload` as `<out_dir>/<name>.json`; the path."""
    path = Path(out_dir) / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))
    return path


def device_report(device) -> dict[str, Any]:
    """Where a report's numbers were taken: the card's name, or the CPU."""
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def launch_counts() -> dict[str, int]:
    """The hand kernels' launches in this process so far."""
    from ..ops.cuda import LAUNCHES

    return {k: v for k, v in LAUNCHES.items() if v}
