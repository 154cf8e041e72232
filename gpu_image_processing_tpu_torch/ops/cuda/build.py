"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each `<name>.cu` beside this module is compiled on first use into a shared
library with a plain C interface, for Hopper only
(`-gencode arch=compute_90a,code=sm_90a`).  The library lands in
`BUILD_DIR` under a name keyed by a hash of the sources, the headers and
the flags (their contents, not their paths), so an edited source rebuilds,
an unchanged one loads at once, and a checkout and an installed package
agree on every name.  `BUILD_DIR` is `_build/` beside the sources (listed in
`.gitignore`) where this process may write there, as in a checkout; else,
as in a read-only install, `gpu_image_processing_tpu_torch/` in the user's
cache directory (`$XDG_CACHE_HOME`, by default `~/.cache`).

The launch functions take `tensor.data_ptr()`, sizes and PyTorch's current
stream as plain integers, launch on that stream without synchronising, and
return `cudaGetLastError()`; `check` turns a non-zero code into an error.
The codec's library (utils/native_codec.py) is host code: the JAX
package's C++ codec tier, `native/src/gip_codec.cpp` (PNG on zlib, the
file writers), `gip_jpeg.cpp` and `gip_formats.cpp`, compiled where they
stand into one library, `DECODERS`: in a checkout at its root, in an
installed package from the copies it carries (core/files.py).  It is
built with the host C++ compiler (`CXX_FLAGS`, then `-lz`), not nvcc, so
that it builds on any host with a C++ compiler and zlib's header and
library, the card's or not; a host without them fails the build.  It lands
in `BUILD_DIR` beside the kernels, keyed the same way, as does one
executable: the HTTP load generator of the serving checks
(`tools/silicon_ci.py`), `native/tools/loadgen.cpp` compiled where it
stands (`LOADGEN`, `build_loadgen`), in a checkout only.

A build failure raises with the compiler's stderr, a missing source with
its name.  Nothing here falls back to another path.
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

from ...core.files import CARRIED, repo_file

SOURCE_DIR = Path(__file__).resolve().parent


def _build_dir() -> Path:
    """`_build/` beside the sources where this process may write there, else
    the package's directory in the user's cache."""
    local = SOURCE_DIR / "_build"
    probe = local if local.is_dir() else SOURCE_DIR
    # Root may write anywhere; a directory whose mode lets no one write (an
    # install made read-only) counts as read-only for root too.
    if os.access(probe, os.W_OK) and probe.stat().st_mode & 0o222:
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return Path(cache) / "gpu_image_processing_tpu_torch"


BUILD_DIR = _build_dir()
#: The codec's library (PNG, the upload decoders, the file writers), built
#: from `CARRIED`: the JAX package's C++ codec tier in `native/src` (three
#: sources and the header they include), compiled as it stands.
DECODERS = "gip_decoders"
#: The libraries built by nvcc: the kernels.
SOURCES = ("blur", "sobel")
#: Every library the port builds.
LIBRARIES = (*SOURCES, DECODERS)
#: The load generator, an executable, and its source in the repository.
LOADGEN = "loadgen"
LOADGEN_SOURCE = "native/tools/loadgen.cpp"

#: Hopper only; `-fmad=false` keeps every multiply and add rounded apart
#: (the kernels also use `_rn` intrinsics).  Never `--use_fast_math`.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "--ptxas-options=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: The host library: plain C++17, no CUDA.  `--no-undefined` makes a missing
#: symbol a build error, not a failure at load time.
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wl,--no-undefined")
#: The libraries `DECODERS` links, after its sources: zlib, for the PNG
#: tier of gip_codec.cpp (`GIP_HAVE_LIBDEFLATE` stays undefined).
CXX_LIBS = ("-lz",)
#: The load generator: plain C++17 with POSIX threads.
EXE_FLAGS = ("-std=c++17", "-O2", "-pthread")

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


def _repo_sources(name: str) -> list[Path]:
    """The repository files outside the package that `name` builds from."""
    if name == DECODERS:
        return [repo_file(p, "the upload decoders build from it")
                for p in CARRIED]
    return [repo_file(LOADGEN_SOURCE, "the load generator of the serving "
                      "checks (tools/silicon_ci.py) builds from it")]


def _inputs(name: str) -> tuple[tuple[str, ...], list[Path]]:
    """(flags, every file the library is built from) of library `name`."""
    if name == DECODERS:
        return (*CXX_FLAGS, *CXX_LIBS), _repo_sources(name)
    if name == LOADGEN:
        return EXE_FLAGS, _repo_sources(name)
    return NVCC_FLAGS, [SOURCE_DIR / f"{name}.cu",
                        *sorted(SOURCE_DIR.glob("*.cuh"))]


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
                *(str(p) for p in _repo_sources(name) if p.suffix == ".cpp"),
                *CXX_LIBS]
    if name == LOADGEN:
        return [cxx_path(), *EXE_FLAGS, "-o", target,
                *map(str, _repo_sources(name))]
    return [nvcc_path(), *NVCC_FLAGS, "-o", target,
            str(SOURCE_DIR / f"{name}.cu")]


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
    """The library (or executable) of `<name>`, compiled now unless it
    already exists."""
    suffix = "" if name == LOADGEN else ".so"
    target = BUILD_DIR / f"{name}-{_source_hash(name)}{suffix}"
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


def build_loadgen() -> Path:
    """The load generator's executable, built first if needed; raises with
    the compiler's stderr if the build fails."""
    with _LOCK:
        return _built(LOADGEN)


def load_host(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Library `name` (`<name>.cu` or `DECODERS`), built
    first if needed; raises with the compiler's stderr if the build fails.

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
