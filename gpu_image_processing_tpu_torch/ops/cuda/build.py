"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `<name>.cu` beside this module is compiled on first use into a shared
library with a plain C interface, for Hopper only
(`-gencode arch=compute_90a,code=sm_90a`).  A `<name>.cpp` is a host helper
(the PNG unfilter of utils/image.py), built by the same step with nvcc
driving the host compiler.  The library lands in `_build/` beside the
sources (listed in `.gitignore`) under a name keyed by a hash of the
sources, the headers and the flags, so an edited source rebuilds and an
unchanged one loads at once.

The launch functions take `tensor.data_ptr()`, sizes and PyTorch's current
stream as plain integers, launch on that stream without synchronising, and
return `cudaGetLastError()`; `check` turns a non-zero code into an error.
The image decoders of the upload codec (utils/native_codec.py) are host
code too: `native/src/gip_jpeg.cpp` and `native/src/gip_formats.cpp`, which
need only standard headers, are compiled where they stand into one library,
`DECODERS`, with the host C++ compiler (`CXX_FLAGS`), not nvcc, so that it
builds on any host with a C++ compiler, the card's or not.  It lands in
`_build/` beside the kernels, keyed the same way.

A build failure raises with the compiler's stderr.  Nothing here falls back
to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR / "_build"
#: The library of the upload decoders, and its sources in the repository's
#: `native/src` (the JAX package's C++ codec tier, compiled as it stands).
DECODERS = "gip_decoders"
NATIVE_DIR = SOURCE_DIR.parents[2] / "native" / "src"
DECODER_SOURCES = (NATIVE_DIR / "gip_jpeg.cpp", NATIVE_DIR / "gip_formats.cpp")
#: The libraries built by nvcc: the kernels, then the host PNG helper.
SOURCES = ("blur", "sobel", "png_unfilter")
#: Every library the port builds.
LIBRARIES = (*SOURCES, DECODERS)

#: Hopper only; `-fmad=false` keeps every multiply and add rounded apart
#: (the kernels also use `_rn` intrinsics).  Never `--use_fast_math`.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "--ptxas-options=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: The decoders: plain C++17, no CUDA.  `--no-undefined` makes a missing
#: symbol a build error, not a failure at load time.
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wl,--no-undefined")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: The compiler's output (ptxas register and spill report) per built library.
BUILD_LOGS: dict[str, str] = {}
#: Seconds each library took to build in this process.
BUILD_SECONDS: dict[str, float] = {}


def require_hopper(device: torch.device) -> None:
    """Raise unless `device` is a CUDA device of compute capability 9.0."""
    if device.type != "cuda":
        raise RuntimeError(f"the CUDA kernels need a cuda device, not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the hand-written kernels need an sm_90 "
            "card")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a only; {device} has compute "
            f"capability {cap[0]}.{cap[1]}")


def nvcc_path() -> str:
    """The nvcc on PATH, else the one under CUDA_HOME; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.access(os.path.join(CUDA_HOME, "bin", "nvcc"), os.X_OK):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def cxx_path() -> str:
    """The host C++ compiler on PATH (`c++`, else `g++`); raises if neither."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) on PATH")


def _source(name: str) -> Path:
    """`<name>.cu`, else the host source `<name>.cpp`."""
    cu = SOURCE_DIR / f"{name}.cu"
    return cu if cu.exists() else SOURCE_DIR / f"{name}.cpp"


def _inputs(name: str) -> tuple[tuple[str, ...], list[Path]]:
    """(flags, every file the library is built from) of library `name`."""
    if name == DECODERS:
        return CXX_FLAGS, [*DECODER_SOURCES, NATIVE_DIR / "gip_limits.h"]
    return NVCC_FLAGS, [_source(name), *sorted(SOURCE_DIR.glob("*.cuh"))]


def _source_hash(name: str) -> str:
    flags, paths = _inputs(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _command(name: str, target: str) -> list[str]:
    if name == DECODERS:
        return [cxx_path(), *CXX_FLAGS, "-o", target,
                *map(str, DECODER_SOURCES)]
    return [nvcc_path(), *NVCC_FLAGS, "-o", target, str(_source(name))]


def _compile(name: str, target: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = _command(name, tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed to build {name} (exit "
                f"{proc.returncode}):\n{proc.stderr}")
        # Atomic: a concurrent process sees the old name or the whole file.
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def _built(name: str) -> Path:
    """The library of `<name>`, compiled now unless it already exists."""
    target = BUILD_DIR / f"{name}-{_source_hash(name)}.so"
    if not target.exists():
        t0 = time.perf_counter()
        BUILD_LOGS[name] = _compile(name, target)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return target


def build_all(names: tuple[str, ...] = LIBRARIES) -> None:
    """Compile every library that is not built yet, one compiler per
    library, all started together; raises with the first failure's
    stderr."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for _ in pool.map(_built, names):
            pass


def load_host(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Library `name` (`<name>.cpp` or `.cu`, or `DECODERS`), built first
    if needed; raises with the compiler's stderr if the build fails.

    `signatures` maps each function to its ctypes argument types; every one
    returns an int.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(_built(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def load(name: str, device: torch.device,
         signatures: dict[str, list]) -> ctypes.CDLL:
    """The kernel library built from `<name>.cu`, built first if needed.

    `signatures` maps each launch function to its ctypes argument types;
    every one returns a CUDA error code (see `check`).
    """
    require_hopper(device)
    lib = load_host(name, signatures)
    lib.gip_error_string.argtypes = [ctypes.c_int]
    lib.gip_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.gip_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the integer the C side takes."""
    return torch.cuda.current_stream(device).cuda_stream
