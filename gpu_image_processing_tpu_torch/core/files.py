"""The repository's files that the port reads from outside its own modules.

A wheel carries the sources of the codec's library (`CARRIED`) under
`CARRIED_DIR`, at their paths from the repository's root: `setup.py` copies
them there when the wheel is built.  A checkout has them at its root.  The
other files the tools read from outside the package only a checkout has:
the web UI (`frontend/`), the numpy oracle (`tests/oracle_numpy.py`) and
the load generator's source (`native/tools/loadgen.cpp`).
"""

from __future__ import annotations

from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
#: Where an installed package carries repository files (absent in a checkout).
CARRIED_DIR = PACKAGE_DIR / "_carried"
#: The directory that holds the package: the repository's root in a
#: checkout, else the installation's (site-packages, or a `--target`).
ROOT_DIR = PACKAGE_DIR.parent
#: The repository files a wheel carries, from the repository's root; the
#: codec's library (PNG on zlib, the upload decoders, the file writers) is
#: built from them (ops/cuda/build.py).
CARRIED = ("native/src/gip_codec.cpp", "native/src/gip_jpeg.cpp",
           "native/src/gip_formats.cpp", "native/src/gip_limits.h")


def repo_file(relative: str, needed_for: str = "") -> Path:
    """The repository file or directory `relative` (a path from the root):
    the package's carried copy first, then the checkout's.  Raises
    FileNotFoundError naming it, and what needs it, when neither has it."""
    for root in (CARRIED_DIR, ROOT_DIR):
        path = root / relative
        if path.exists():
            return path
    if relative in CARRIED:
        why = (f"the package does not carry it ({CARRIED_DIR}) and lies in no "
               f"checkout ({ROOT_DIR})")
    else:
        why = (f"only a checkout of the repository has it, and the package "
               f"lies in none ({ROOT_DIR})")
    raise FileNotFoundError(f"{relative} not found: {why}"
                            + (f"; {needed_for}" if needed_for else ""))
