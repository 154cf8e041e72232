"""The validation matrix on the card: every filter x level x channel count
(1, 3, 4) x radius extreme through `FilterRuntime(device)`, held against the
independent numpy oracle (`tests/oracle_numpy.py`), with the level-4 gates,
the rows Sobel against the planar Sobel, and the shapes that cross the
kernels' tiles: a full-width r = 15 row band, a batch, an 8K-wide box, box
r = 5 at 768x1092 and box r = 500 at width 3239.

The port of the JAX system's `scripts/tpu_validation.py` (:62-200), with the
port's numerics contract as its gates:
  * gaussian and box at levels 1 and 2, and grey Sobel: exact;
  * colour Sobel: maxdiff <= 6 on <= 0.1% of values (a grey value on a .5
    tie may round either way), and every channel of a pixel equal;
  * level 4: within 1 of level 2 (gaussian, box); the level-4 Sobel of the
    rows kernel within 1 of the planar one (on <= 0.1% of values).
Left out: the `bench.py` fingerprint check (:111-119; `bench.py` is not
ported), the XLA-tier routing case (:203-209; the port has no XLA tier) and
the `use_mxu_sobel` routing asserts (:137, :152; the port's Sobel has one
route a level).

Usage, from the root of the repository:

    python -m gpu_image_processing_tpu_torch.tools.validation \
        [--device cuda|cpu] [--workers N] [--out-dir DIR]

Prints one line a check, then `TOTAL FAILURES: n`, and writes
`validation.json`; exits 1 on any failure.  Without CUDA it raises unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..ops.cuda import sobel, sobel_planar
from ..ops.cuda.api import to_planes
from ..ops.weights import gaussian_kernel_f32
from ..runtime.dispatch import FilterRuntime
from .verification import (Checks, OraclePool, common_arguments,
                           device_report, diff_fraction, launch_counts,
                           maxdiff, write_report)

SEED = 99                       # scripts/tpu_validation.py:60
MATRIX_SHAPE = (310, 421)
MATRIX_GAUSS = ((1, 0.5), (3, 2.0), (15, 8.0))   # (radius, sigma)
MATRIX_BOX = (1, 15)
# Colour Sobel (tests/sobel_tolerance.py): <= 6 on <= 0.1% of values.
SOBEL_MAX_DIFF, SOBEL_MAX_FRACTION = 6, 1e-3
WIDE = (96, 3239, 3)            # a full-width row band of the README image

Gate = Callable[[np.ndarray, np.ndarray], tuple[bool, str]]


def exact(out: np.ndarray, want: np.ndarray) -> tuple[bool, str]:
    d = maxdiff(out, want)
    return d == 0, f"maxdiff {d}"


def within_one(out: np.ndarray, want: np.ndarray) -> tuple[bool, str]:
    d = maxdiff(out, want)
    return d <= 1, f"maxdiff {d}"


def sobel_colour(out: np.ndarray, want: np.ndarray) -> tuple[bool, str]:
    d, frac = maxdiff(out, want), diff_fraction(out, want)
    return (d <= SOBEL_MAX_DIFF and frac <= SOBEL_MAX_FRACTION,
            f"maxdiff {d}, {frac:.1e} differ")


def within_one_rare(out: np.ndarray, want: np.ndarray) -> tuple[bool, str]:
    d, frac = maxdiff(out, want), diff_fraction(out, want)
    return d <= 1 and frac <= SOBEL_MAX_FRACTION, f"maxdiff {d}, {frac:.1e} differ"


class Matrix:
    """The checks, each made when its oracle value is ready, in order."""

    def __init__(self, pool: OraclePool):
        self.pool = pool
        self.pending: list[tuple[str, Callable[[], tuple[bool, str]]]] = []
        #: label -> (result, oracle function, its arguments) of each case
        #: held against the oracle.
        self.cases: dict[str, tuple[np.ndarray, str, tuple]] = {}

    def against_oracle(self, label: str, out: np.ndarray, gate: Gate,
                       fn_name: str, *args) -> None:
        future = self.pool.submit(fn_name, *args)
        self.cases[label] = (out, fn_name, args)
        self.pending.append((label, lambda: gate(out, future.result())))

    def against(self, label: str, out: np.ndarray, want: np.ndarray,
                gate: Gate) -> None:
        self.pending.append((label, lambda: gate(out, want)))

    def holds(self, label: str, ok: bool, detail: str = "") -> None:
        self.pending.append((label, lambda: (ok, detail)))

    def finish(self, checks: Checks) -> None:
        for label, check in self.pending:
            checks(label, *check())


def run_matrix(rt: FilterRuntime, matrix: Matrix) -> None:
    """Every check of the tool, in the JAX script's order and draws."""
    rng = np.random.default_rng(SEED)
    h, w = MATRIX_SHAPE
    for c in (1, 3, 4):
        img = rng.integers(0, 256, (h, w, c), np.uint8)
        for level in (1, 2):
            for radius, sigma in MATRIX_GAUSS:
                out, _ = rt.gaussian_blur(img, sigma=sigma, radius=radius,
                                          level=level)
                matrix.against_oracle(
                    f"gauss c{c} L{level} r{radius}", out, exact,
                    "gaussian_blur", img, gaussian_kernel_f32(radius, sigma),
                    radius)
            for radius in MATRIX_BOX:
                out, _ = rt.box_blur(img, radius=radius, level=level)
                matrix.against_oracle(f"box   c{c} L{level} r{radius}", out,
                                      exact, "box_blur", img, radius)
            out, _ = rt.sobel_edge_detection(img, level=level)
            if c > 1:
                matrix.against_oracle(f"sobel c{c} L{level} (colour gate)",
                                      out, sobel_colour, "sobel", img, level)
                # Every channel of a pixel holds the same magnitude, apart
                # from the oracle's gate: a tie flipped in one channel would
                # hide inside maxdiff <= 6.
                matrix.holds(f"sobel c{c} L{level} channels-equal",
                             bool((out == out[:, :, :1]).all()))
            else:
                matrix.against_oracle(f"sobel c{c} L{level}", out, exact,
                                      "sobel", img, level)

    # Level-4 (ADVANCED) gates: within 1 of level 2.
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    l2, _ = rt.gaussian_blur(img, level=2)
    l4, _ = rt.gaussian_blur(img, level=4)
    matrix.against("gauss L4 gate<=1 (band, r3)", l4, l2, within_one)
    b2, _ = rt.box_blur(img, radius=5, level=2)
    b4, _ = rt.box_blur(img, radius=5, level=4)
    matrix.against("box L4 gate<=1", b4, b2, within_one)
    m2, _ = rt.gaussian_blur(img, sigma=4.0, radius=15, level=2)
    m4, _ = rt.gaussian_blur(img, sigma=4.0, radius=15, level=4)
    matrix.against("gauss L4 r15 (band) gate<=1", m4, m2, within_one)

    # The rows Sobel against the planar Sobel (K7) at a full-width shape:
    # the counterpart of the TPU's matrix-unit tier against its baseline.
    simg = rng.integers(0, 256, WIDE, np.uint8)
    rows = torch.from_numpy(simg.reshape(WIDE[0], -1)).to(rt.device)
    planes = to_planes(torch.from_numpy(simg).to(rt.device))
    for level, rows_fn, planar_fn, gate in (
            (2, sobel.sobel_rows, sobel_planar.sobel_planar, sobel_colour),
            (4, sobel.sobel_f32_rows, sobel_planar.sobel_f32_planar,
             within_one_rare)):
        a = rows_fn(rows, WIDE[1], WIDE[2]).cpu().numpy().reshape(WIDE)
        b = planar_fn(planes).permute(1, 2, 0).cpu().numpy()
        matrix.against(f"sobel L{level} rows vs planar {'x'.join(map(str, WIDE))}",
                       a, b, gate)

    # A full-width row band at r = 15: 31 taps across the 512-lane strips.
    wide = rng.integers(0, 256, WIDE, np.uint8)
    w2, _ = rt.gaussian_blur(wide, sigma=4.0, radius=15, level=2)
    matrix.against_oracle("gauss L2 r15 full-width rows bit-exact", w2, exact,
                          "gaussian_blur", wide, gaussian_kernel_f32(15, 4.0),
                          15)

    # A batch through run_batch: each image clamped at its own edges.
    imgs = np.stack([rng.integers(0, 256, (64, 97, 3), np.uint8)
                     for _ in range(4)])
    out, _ = rt.run_batch("gaussian", imgs, level=2, sigma=2.0, radius=3)
    for i in range(4):
        matrix.against_oracle(f"batch gauss L2 image {i}", out[i], exact,
                              "gaussian_blur", imgs[i],
                              gaussian_kernel_f32(3, 2.0), 3)

    # 8K wide: 23040 lanes, 45 strips of 512.
    img = rng.integers(0, 256, (48, 7680, 3), np.uint8)
    out, _ = rt.box_blur(img, radius=15, level=2)
    matrix.against_oracle("box 8K-wide r15 (23040 lanes)", out, exact,
                          "box_blur", img, 15)
    # 0.84 MP at r = 5: the shape the TPU routed by its size gate.
    img = rng.integers(0, 256, (768, 1092, 3), np.uint8)
    out, _ = rt.box_blur(img, radius=5, level=2)
    matrix.against_oracle("box 0.84MP r5", out, exact, "box_blur", img, 5)
    # r = 500, wider than the one-launch running sums: box_wide_h/_v.
    img = rng.integers(0, 256, (64, 3239, 3), np.uint8)
    out, _ = rt.box_blur(img, radius=500, level=2)
    matrix.against_oracle("box r500 w3239 (two launches)", out, exact,
                          "box_blur", img, 500)


def validate(rt: FilterRuntime, workers: int) -> tuple[Checks, Matrix]:
    """Run the matrix on `rt` with `workers` oracle processes."""
    checks = Checks()
    with OraclePool(workers) as pool:
        matrix = Matrix(pool)
        run_matrix(rt, matrix)
        matrix.finish(checks)
    return checks, matrix


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common_arguments(parser)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    rt = FilterRuntime(args.device)
    checks, _ = validate(rt, args.workers)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    path = write_report(args.out_dir, "validation", {
        "device": device_report(rt.device), "checks": checks.records,
        "failures": checks.failures, "seconds": seconds,
        "launches": launches})
    print(f"LAUNCHES {json.dumps(launches)}")
    print(f"{len(checks.records)} checks in {seconds:.1f} s; report {path}")
    print(f"TOTAL FAILURES: {checks.failures}", flush=True)
    return 1 if checks.failures else 0


if __name__ == "__main__":
    sys.exit(main())
