"""Run one cell of the port's benchmark once with the port's span recorder
on.

    python3 portbench/run_spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

As `run.py`, with the recorder (`core/spans.py`) on from before the
program starts (`harness/program_spans.py::recording`): each entry's
counters carry the recorder's totals and the timing brackets' counts, a
`--trace 1` run reads the per-layer metrics of `program_spans.json` beside
`BENCHMARK.json`'s and labels each idle gap that has no CUDA call at its
middle by the innermost span open there.  A `--trace 0` run gives the
end-to-end metrics with the recorder on, to set against `run.py`'s (off),
and the metrics of `program_spans.json` without the profiler's cost.
The result adds `spans_dropped`, the spans past the recorder's capacity.
Exits 4 where the port has no recorder.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import chip, program_spans, runner  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        with program_spans.recording() as spans:
            result = runner.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), PROCESS_START)
            result["spans_dropped"] = spans.dropped()
    except program_spans.NoRecorder as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 4
    except chip.NoChip as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    except chip.Forbidden as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    runner.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
