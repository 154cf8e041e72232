"""Count the SASS instructions of the port's kernels, phase by phase.

Usage, from the root of the repository, on a machine with nvcc:

    python3 gpu_image_processing_tpu_torch/tools/sass_counts.py \
        [--library blur] [--kernel 'gauss_window_rowsIN3gip8WeightedELi3E']

builds the library (ops/cuda/build.py), disassembles it with `cuobjdump
-sass`, and for each kernel whose mangled name contains KERNEL prints its
instruction count and its resources (`cuobjdump -res-usage`: registers a
thread, stack and local bytes, which spills take), then the count of each
phase between two block barriers (BAR.SYNC) with its multiplies (FMUL),
adds (FADD), shared loads and stores, device stores, constant loads (LDC)
and local loads and stores (LDL, STL).
`ncu` gives no counters on the card's machine; the static counts of the
unrolled tap loops stand in for them.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

CUOBJDUMP = "cuobjdump"
# The default kernels: the weighted gaussian at r = 3 (rows and planes
# launch the same instantiation) and the level-2 Sobel at C = 3, whose
# pattern matches both layouts (sobel_tile_rows<true, 3, false> for rows,
# <true, 3, true> for planes).
DEFAULTS = {
    "blur": "gauss_window_rowsIN3gip8WeightedELi3E",
    "sobel": "sobel_tile_rowsILb1ELi3E",
}
# LDC: a constant loaded into a register (a multiply that takes its weight
# from the constant bank needs none); LDL/STL: local memory (spills).
SHOWN = ("FMUL", "FADD", "LDS", "STS", "STG", "LDC", "LDL", "STL")


def functions(sass: str) -> dict[str, list[str]]:
    """Mangled name -> its instructions, predicates stripped."""
    out: dict[str, list[str]] = collections.defaultdict(list)
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name:
            out[name].append(re.sub(r"^@!?U?P\w+\s+", "", m.group(1)))
    return out


def resources(usage: str) -> dict[str, str]:
    """Mangled name -> its `cuobjdump -res-usage` line (REG, STACK, SHARED,
    LOCAL, ...)."""
    out = {}
    name = None
    for line in usage.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            out[name] = " ".join(line.split())
            name = None
    return out


def opcode(instruction: str) -> str:
    return instruction.split()[0].split(".")[0]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--library", default="blur", choices=sorted(DEFAULTS))
    parser.add_argument("--kernel", default=None,
                        help="a part of the mangled kernel name")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from gpu_image_processing_tpu_torch.ops.cuda import build

    library = build._built(args.library)
    tool = shutil.which(CUOBJDUMP) or str(
        Path(build.nvcc_path()).parent / CUOBJDUMP)
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    usage = resources(subprocess.run(
        [tool, "-res-usage", str(library)], capture_output=True, text=True,
        check=True).stdout)
    pattern = args.kernel or DEFAULTS[args.library]
    found = False
    for name, ins in functions(sass).items():
        if pattern not in name:
            continue
        found = True
        print(f"{name}: {len(ins)} instructions; {usage.get(name, 'no resource line')}")
        bars = [i for i, s in enumerate(ins) if s.startswith("BAR.SYNC")]
        for a, b in zip([0] + bars, bars + [len(ins)]):
            counts = collections.Counter(opcode(s) for s in ins[a:b])
            print(f"  phase {a}-{b}: {b - a} instructions; " + ", ".join(
                f"{op} {counts.get(op, 0)}" for op in SHOWN))
    if not found:
        print(f"no kernel matches {pattern}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
