"""Randomized soak on the card: random shapes through the port's serving
runtime and its planar tier, held against the independent numpy oracle
(`tests/oracle_numpy.py`).

The port of the JAX system's `scripts/soak_fuzz.py`:

1. N trials of a random filter, level (1, 2, 4), radius and shape through
   `FilterRuntime(device)`, the JAX soak's draws in its order (:41-102):
   heights biased to multiples of 64 +- 3 every third trial;
2. N // 2 gaussian trials at random sigmas (:104-126);
3. N // 3 trials of the planar kernels K5 and K7 where the port's routes
   still reach them (`ops/cuda/api.py`), in place of the JAX soak's
   matrix-unit Sobel section (:128-172), which is the TPU's: images past the
   rows kernels' channel caps (`blur.GAUSS_MAX_CHANNELS`,
   `blur.BOX_MAX_CHANNELS`) through `models/` at levels 1 and 2 and the
   registry's level-4 keys (the folded planar gaussian below r = 3, the band
   on planes from it); row bands with halo rows (`rows_prepadded`), held
   against the oracle's rows of the whole image; the Sobel batch with
   `zero_rows=False`.  Widths k*512 +- 3, heights k*8 +- 3 and k*64 +- 3.
   Every `FOLDED_EVERY`-th trial is a level-4 gaussian below r = 3 on one
   of the planar blur's routes, so the folded planar gaussian, which the
   other draws reach in about 1 trial of 30, runs in at least N // 30.
   A third generator draws this section, so that its trials do not depend
   on the first two sections'.

Sections 1 and 2 keep the JAX soak's trials draw for draw, except every
third one (trial % 3 == 1), whose shape and image a second generator draws
at the port's tile edges instead: W*C near a multiple of 128 or 512 (the
rows kernels' 512-lane strips, the Sobel's 128-lane tiles, the band's
64x128 tiles), H near a multiple of 8 or 64 (the Sobel's 8-row tiles, the
band's 64-row tiles).  The JAX trial's image is still drawn, so the other
trials stay the JAX soak's.

Gates, the port's contract, tighter than the JAX soak's (it allowed the
gaussian 1 for FMA contraction; the port builds with -fmad=false):
gaussian and box at levels 1 and 2 exact; level 4 within 1; grey Sobel
exact; colour Sobel maxdiff <= 6 (the 0.1% share is binomially noisy on
shapes this small, :98-101); level-4 Sobel against the level-1 oracle.

Usage, from the root of the repository:

    python -m gpu_image_processing_tpu_torch.tools.soak [N] \
        [--seed 20260817] [--device cuda|cpu] [--workers W] [--out-dir DIR]

Prints each failing trial, each section's count and `SOAK DONE: n
failures`, writes `soak.json`; exits 1 on any failure or exception.
Without CUDA it raises unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..models import BoxBlur, GaussianBlur
from ..ops import fused
from ..ops.cuda import LAUNCHES, blur, blur_planar, sobel_planar
from ..ops.cuda.api import sobel_planar_batch, to_planes
from ..ops.weights import gaussian_kernel_f32, weights_to_torch
from ..runtime.dispatch import FilterRuntime
from .verification import (OraclePool, common_arguments, device_report,
                           launch_counts, maxdiff, write_report)

SEED = 20260817                 # scripts/soak_fuzz.py:40
TRIALS = 150
SOBEL_MAX_DIFF = 6
PLANAR_KERNELS = ("gaussian_planar", "gaussian_folded_planar", "box_planar",
                  "sobel_planar", "sobel_f32_planar")
#: Section 3's trials 0, 10, 20, ... are level-4 gaussians below r = 3.
FOLDED_EVERY = 10


@dataclass
class Trial:
    """One trial's result, waiting for its oracle value(s)."""

    label: str
    outs: list[np.ndarray]
    wants: list            # futures of the oracle's arrays
    max_diff: int
    fix: Optional[Callable[[np.ndarray], np.ndarray]] = None

    def failure(self) -> Optional[str]:
        worst = 0
        for out, future in zip(self.outs, self.wants):
            want = future.result()
            if self.fix is not None:
                want = self.fix(want)
            worst = max(worst, maxdiff(out, want))
        return (None if worst <= self.max_diff
                else f"maxdiff {worst} > {self.max_diff}")


@dataclass
class Section:
    name: str
    trials: list[Trial] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)


def edge_shape(rng: np.random.Generator, c: int) -> tuple[int, int]:
    """(h, w) at the port's tile edges: W*C within about 2C lanes of a
    multiple of 128 or 512, H within 3 of a multiple of 8 or 64."""
    lanes = int(rng.choice([128, 512])) * int(rng.integers(1, 3))
    w = max(3, round(lanes / c) + int(rng.integers(-2, 3)))
    if rng.integers(0, 2):
        h = 8 * int(rng.integers(1, 9)) + int(rng.integers(-3, 4))
    else:
        h = 64 * int(rng.integers(1, 4)) + int(rng.integers(-3, 4))
    return max(h, 1), w


def blur_gate(level: int) -> int:
    """Largest difference a blur may show: none at levels 1 and 2, 1 at
    level 4."""
    return 1 if level == 4 else 0


def sobel_trial(label: str, outs: list[np.ndarray], wants: list, c: int,
                fix=None) -> Trial:
    """Grey Sobel exact, colour within SOBEL_MAX_DIFF."""
    return Trial(label, outs, wants, 0 if c == 1 else SOBEL_MAX_DIFF, fix=fix)


def section_rows(rt: FilterRuntime, pool: OraclePool, rng, edge_rng,
                 n: int) -> Section:
    """Section 1: random filters, levels and shapes through the runtime."""
    sec = Section("1 runtime")
    for trial in range(n):
        # bias toward band-boundary heights (the JAX soak's row-fill zone)
        if trial % 3 == 0:
            base = int(rng.integers(1, 4)) * 64
            h = base + int(rng.integers(-3, 4))
            h = max(h, 1)
        else:
            h = int(rng.integers(1, 200))
        w = int(rng.integers(3, 200))
        c = int(rng.choice([1, 3, 4]))
        img = rng.integers(0, 256, (h, w, c), np.uint8)
        kind = int(rng.integers(0, 3))
        lvl = int(rng.choice([1, 2, 4]))
        r, sigma = 0, 0.0
        if kind == 0:
            r = int(rng.integers(1, 16))
            sigma = float(rng.uniform(0.5, 8))
        elif kind == 1:
            r = int(rng.integers(1, 30))
        if trial % 3 == 1:
            h, w = edge_shape(edge_rng, c)
            img = edge_rng.integers(0, 256, (h, w, c), np.uint8)
        label = f"[{trial}] h={h} w={w} c={c} lvl={lvl}"
        try:
            if kind == 0:
                out, _ = rt.gaussian_blur(img, sigma=sigma, radius=r, level=lvl)
                sec.trials.append(Trial(
                    f"{label} GAUSS r={r} s={sigma:.2f}", [out],
                    [pool.submit("gaussian_blur", img,
                                 gaussian_kernel_f32(r, sigma), r)],
                    blur_gate(lvl)))
            elif kind == 1:
                out, _ = rt.box_blur(img, radius=r, level=lvl)
                sec.trials.append(Trial(
                    f"{label} BOX r={r}", [out],
                    [pool.submit("box_blur", img, r)], blur_gate(lvl)))
            else:
                # Level 4 serves the level-1 numerics (the grey value in f32).
                out, _ = rt.sobel_edge_detection(img, level=lvl)
                sec.trials.append(sobel_trial(
                    f"{label} SOBEL", [out],
                    [pool.submit("sobel", img, 1 if lvl == 4 else lvl)], c))
        except Exception:
            sec.errors.append(f"{label} kind={kind} r={r}: "
                              f"{traceback.format_exc(limit=3)}")
    return sec


def section_gaussian(rt: FilterRuntime, pool: OraclePool, rng, edge_rng,
                     n: int) -> Section:
    """Section 2: the gaussian at random sigmas, heights at 64k +- 3."""
    sec = Section("2 gaussian")
    for trial in range(n):
        base = int(rng.integers(1, 4)) * 64
        h = max(base + int(rng.integers(-3, 4)), 1)
        w = int(rng.integers(3, 160))
        c = int(rng.choice([1, 3, 4]))
        r = int(rng.integers(1, 16))
        sigma = float(rng.uniform(0.5, 8))
        lvl = int(rng.choice([1, 2, 4]))
        img = rng.integers(0, 256, (h, w, c), np.uint8)
        if trial % 3 == 1:
            h, w = edge_shape(edge_rng, c)
            img = edge_rng.integers(0, 256, (h, w, c), np.uint8)
        label = f"[g{trial}] h={h} w={w} c={c} r={r} s={sigma:.2f} lvl={lvl}"
        try:
            out, _ = rt.gaussian_blur(img, sigma=sigma, radius=r, level=lvl)
            sec.trials.append(Trial(
                f"{label} GAUSS", [out],
                [pool.submit("gaussian_blur", img,
                             gaussian_kernel_f32(r, sigma), r)],
                blur_gate(lvl)))
        except Exception:
            sec.errors.append(f"{label}: {traceback.format_exc(limit=3)}")
    return sec


def planar_shape(rng) -> tuple[int, int]:
    """(h, w): W = k*512 +- 3, H = k*8 +- 3 or k*64 +- 3."""
    w = 512 * int(rng.integers(1, 3)) + int(rng.integers(-3, 4))
    if rng.integers(0, 2):
        h = 8 * int(rng.integers(1, 9)) + int(rng.integers(-3, 4))
    else:
        h = 64 * int(rng.integers(1, 4)) + int(rng.integers(-3, 4))
    return max(h, 3), w


def zero_border_rows(edge: np.ndarray, top: bool, bottom: bool) -> np.ndarray:
    """The caller's part of `zero_rows=False`: zero the rows that are the
    whole image's first and last."""
    edge = edge.copy()
    if top:
        edge[..., 0, :, :] = 0
    if bottom:
        edge[..., -1, :, :] = 0
    return edge


def section_planar(rt: FilterRuntime, pool: OraclePool, rng,
                   n: int) -> Section:
    """Section 3: K5 and K7 where the port's routes reach them."""
    sec = Section("3 planar")
    dev = rt.device
    adv: dict = {}
    fused.register_all(adv.__setitem__)
    for trial in range(n):
        folded = trial % FOLDED_EVERY == 0
        route = int(rng.integers(0, 2 if folded else 3))
        filt = "gaussian" if folded else str(rng.choice(
            ["gaussian", "box", "sobel"]))
        lvl = 4 if folded else int(rng.choice([1, 2, 4]))
        h, w = planar_shape(rng)
        # Level 4 folds the gaussian's taps below r = 3 and runs the band
        # from it: both sides of that edge, about half the time each.
        r = (int(rng.integers(1, 3 if folded else 6 if lvl == 4 else 16))
             if filt == "gaussian" else int(rng.integers(1, 41)))
        sigma = float(rng.uniform(0.5, 8))
        table = gaussian_kernel_f32(r, sigma)
        label = f"[p{trial}] h={h} w={w} lvl={lvl}"
        try:
            if route == 0 and filt != "sobel":
                # Past the rows kernels' channel caps: one plane a channel.
                cap = (blur.GAUSS_MAX_CHANNELS if filt == "gaussian"
                       else blur.BOX_MAX_CHANNELS)
                c = cap + int(rng.integers(1, 9))
                img = rng.integers(0, 256, (h, w, c), np.uint8)
                x = torch.from_numpy(img).to(dev)
                if filt == "gaussian":
                    fn = (lambda t: adv["gaussian_adv"](t, table, r)) if lvl == 4 \
                        else GaussianBlur(sigma, r, lvl)
                    want = pool.submit("gaussian_blur", img, table, r)
                else:
                    fn = (lambda t: adv["box_adv"](t, r)) if lvl == 4 \
                        else BoxBlur(r, lvl)
                    want = pool.submit("box_blur", img, r)
                out = fn(x).cpu().numpy()
                sec.trials.append(Trial(f"{label} c={c} {filt.upper()} r={r} "
                                        f"past the channel cap", [out], [want],
                                        blur_gate(lvl)))
            elif route in (0, 1):
                # A row band [a, z) with halo rows, as a shard receives it
                # (Sobel has no channel cap, so its route 0 is a band too).
                c = int(rng.choice([1, 3, 4]))
                img = rng.integers(0, 256, (h, w, c), np.uint8)
                a = int(rng.integers(0, h - 1))
                z = int(rng.integers(a + 1, h + 1))
                # The planar blur takes r <= 31 (MAX_KERNEL_TAPS).
                halo = 1 if filt == "sobel" else min(r, 31)
                rows = np.clip(np.arange(a - halo, z + halo), 0, h - 1)
                planes = to_planes(torch.from_numpy(img[rows]).to(dev))
                what = f"{label} c={c} band {a}-{z} with halo rows"
                if filt == "sobel":
                    fn = (sobel_planar.sobel_planar if lvl == 2
                          else sobel_planar.sobel_f32_planar)
                    out = fn(planes, True, False).permute(1, 2, 0).cpu().numpy()
                    out = zero_border_rows(out[None], a == 0, z == h)[0]
                    sec.trials.append(sobel_trial(
                        f"{what} SOBEL", [out],
                        [pool.submit("sobel", img, 1 if lvl == 4 else lvl)], c,
                        fix=lambda want, a=a, z=z: want[a:z]))
                    continue
                if filt == "gaussian":
                    host = weights_to_torch(table, torch.device("cpu"))
                    fn = (blur_planar.gaussian_folded_planar
                          if lvl == 4 and r < 3 else blur_planar.gaussian_planar)
                    out = fn(planes, host, halo, True)
                    want = pool.submit("gaussian_blur", img, table, r)
                else:
                    out = blur_planar.box_planar(planes, halo, True)
                    want = pool.submit("box_blur", img, halo)
                out = out.permute(1, 2, 0).cpu().numpy()
                sec.trials.append(Trial(
                    f"{what} {filt.upper()} r={halo}", [out], [want],
                    blur_gate(lvl), fix=lambda want, a=a, z=z: want[a:z]))
            else:
                # The Sobel batch with zero_rows=False: the caller zeroes
                # each image's first and last rows.
                c = int(rng.choice([1, 3, 4]))
                b = int(rng.integers(1, 4))
                imgs = rng.integers(0, 256, (b, h, w, c), np.uint8)
                out = sobel_planar_batch(torch.from_numpy(imgs).to(dev),
                                         2 if lvl == 2 else 1,
                                         zero_rows=False).cpu().numpy()
                out = zero_border_rows(out, True, True)
                sec.trials.append(sobel_trial(
                    f"{label} c={c} SOBEL batch of {b}, zero_rows=False",
                    list(out), [pool.submit("sobel", im, 1 if lvl == 4 else lvl)
                                for im in imgs], c))
        except Exception:
            sec.errors.append(f"{label} route={route} {filt} r={r}: "
                              f"{traceback.format_exc(limit=3)}")
    return sec


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trials", nargs="?", type=int, default=TRIALS,
                        help="N: trials of section 1 (2: N // 2, 3: N // 3)")
    parser.add_argument("--seed", type=int, default=SEED)
    common_arguments(parser)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    rt = FilterRuntime(args.device)
    rng = np.random.default_rng(args.seed)
    edge_rng = np.random.default_rng([args.seed, 1])
    planar_rng = np.random.default_rng([args.seed, 2])
    n = args.trials
    print(f"soak on {rt.device}: seed {args.seed}, N = {n}", flush=True)
    failures = 0
    report = []
    with OraclePool(args.workers) as pool:
        before = dict(LAUNCHES)
        # What the runtime's executables hold after each section: bounded
        # by the cache's limit whatever the shapes.
        held = []
        sections = [section_rows(rt, pool, rng, edge_rng, n)]
        held.append(rt.executables.stats())
        sections.append(section_gaussian(rt, pool, rng, edge_rng, n // 2))
        held.append(rt.executables.stats())
        planar_before = dict(LAUNCHES)
        sections.append(section_planar(rt, pool, planar_rng, n // 3))
        held.append(rt.executables.stats())
        planar_launches = {k: LAUNCHES[k] - planar_before.get(k, 0)
                           for k in PLANAR_KERNELS}
        for sec in sections:
            bad = [f"{t.label}: {why}" for t in sec.trials
                   if (why := t.failure()) is not None]
            for line in sec.errors:
                print(f"EXC {line}")
            for line in bad:
                print(f"MISMATCH {line}")
            failures += len(bad) + len(sec.errors)
            report.append({"section": sec.name,
                           "trials": len(sec.trials) + len(sec.errors),
                           "mismatches": bad, "exceptions": sec.errors,
                           "executables": held[len(report)]})
            print(f"section {sec.name}: {len(sec.trials) + len(sec.errors)} "
                  f"trials, {len(bad)} mismatches, {len(sec.errors)} "
                  f"exceptions; executables after it "
                  f"{json.dumps(held[len(report) - 1])}", flush=True)
    # On the card every planar kernel must have run in section 3.
    if rt.device.type == "cuda":
        missing = [k for k, v in planar_launches.items() if not v]
        if missing:
            print(f"section 3 never launched {', '.join(missing)}")
            failures += 1
        print(f"section 3 planar launches: {json.dumps(planar_launches)}")
    seconds = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    path = write_report(args.out_dir, "soak", {
        "device": device_report(rt.device), "seed": args.seed, "trials": n,
        "sections": report, "failures": failures, "seconds": seconds,
        "launches": launches})
    print(f"LAUNCHES {json.dumps(launches)}")
    print(f"report {path}; {seconds:.1f} s")
    print(f"SOAK DONE: {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
