"""The readings that the comparison's limits are set from, on the card.

    python3 portbench/limits.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--seconds 6] [--first-seed N]

In one process: the cell run with the program on `--seeds` seeds (the
lower reading of each compared number is the largest they give), then
with the control, the plain reference in bfloat16 in the program's place,
on `--control-seeds` seeds (the upper reading is the smallest).  Each run
is a short window at the cell's own load, its answers sampled and checked
as a benchmark run checks them.  Prints a JSON line a run and one of the
readings.  The benchmark's own runs never run this.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import control, runner  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=6.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = parser.parse_args()
    readings: dict[str, dict[str, list]] = {"program": {}, "control": {}}
    arms = [("program", None, args.seeds),
            ("control", control.control, args.control_seeds)]
    seed = args.first_seed
    for arm, alter, n in arms:
        for _ in range(n):
            t = time.perf_counter()
            r = runner.run_cell(args.workload, seed, args.seconds, False,
                                time.perf_counter(), alter=alter)
            print(json.dumps({"arm": arm, "seed": seed,
                              "correct": r["correct"],
                              "attempted": r["attempted"],
                              "failed": r["failed"], "checked": r["checked"],
                              "s": round(time.perf_counter() - t, 1)}),
                  flush=True)
            for name, (value, _) in r["checked"].items():
                readings[arm].setdefault(name, []).append(value)
            seed += 7919
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(v) for k, v in readings["program"].items()},
        "upper": {k: min(v) for k, v in readings["control"].items()},
        "program": readings["program"], "control": readings["control"]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
