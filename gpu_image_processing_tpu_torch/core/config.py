"""Central configuration for the PyTorch/CUDA image-processing port.

The CUDA reference scatters parameter defaults/ranges across five places that
must stay in sync (bindings defaults `backend/cuda_bindings/bindings.cpp:245-247`,
pydantic defaults `backend/app.py:49-52`, the `/api/filters` catalog
`backend/app.py:147-172`, HTML slider bounds `frontend/index.html:88,97`, and
C++ validation `tests/test_real_image.cu:77-85`).  Here there is exactly one
source of truth; every other layer imports from this module.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default

# ---------------------------------------------------------------------------
# Parameter defaults and ranges (reference: backend/app.py:147-172)
# ---------------------------------------------------------------------------

DEFAULT_SIGMA: float = 2.0
DEFAULT_RADIUS: int = 3
DEFAULT_LEVEL: int = 1

SIGMA_RANGE: tuple[float, float] = (0.5, 20.0)
RADIUS_RANGE: tuple[int, int] = (1, 15)

# The CUDA reference caps the Gaussian weight table at 64 constant-memory
# floats, i.e. radius <= 31 (cuda_lib/src/image_filters.cu:13,729-732).  We
# keep the same hard cap so oversize requests fail the same way.
MAX_KERNEL_TAPS: int = 64

#: Level-4 gaussian: the band kernel from this radius up, folded taps below
#: it (gpu_image_processing_tpu/ops/pallas/blur_mxu.py:87).  Both packages
#: route on radius alone, so they compute the same function at every radius.
GAUSS_MXU_MIN_RADIUS: int = 3

VALID_CHANNELS: tuple[int, ...] = (1, 3, 4)
#: Levels the comparison endpoints iterate over (backend/app.py:332).
VALID_LEVELS: tuple[int, ...] = (1, 2)
#: Levels a single /api/process request may ask for (4 = ADVANCED tier,
#: declared-but-unimplemented in the reference, image_filters.h:28).
REQUEST_LEVELS: tuple[int, ...] = (1, 2, 4)

# ---------------------------------------------------------------------------
# Serving (reference: start_servers.sh:16-17, frontend/js/app.js:2)
# ---------------------------------------------------------------------------

BACKEND_HOST: str = os.environ.get("GIP_TPU_BACKEND_HOST", "0.0.0.0")
BACKEND_PORT: int = _env_int("GIP_TPU_BACKEND_PORT", 8000)
FRONTEND_PORT: int = _env_int("GIP_TPU_FRONTEND_PORT", 8080)

#: Exit code the backend uses to request a worker recycle.  The serving
#: supervisor restarts the backend on exactly this code; anything else is a
#: real exit.
EXIT_RECYCLE: int = 43

#: Timed repetitions behind each served `time_ms` (the least is reported).
TIMING_REPS: int = 2
