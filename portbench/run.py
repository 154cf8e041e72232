"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, this folder and
the port (`gpu_image_processing_tpu_torch`).  Makes its inputs from the
seed, starts the port, warms the cell's shapes, measures for `--seconds`,
checks a seeded sample of the window's answers against the plain
reference, and prints one JSON object as its last line: the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics and the
device trace's breakdown with `--trace 1`.  Without a CUDA card, or with
fewer than the cell asks for, it exits 2 and prints no result; if JAX or
the JAX package is loaded after the window, it exits 3.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import chip, runner  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = runner.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), PROCESS_START)
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
