"""REST API application on the PyTorch/CUDA port.

The endpoints, schemas, status codes and error behaviour of the JAX
package's server (gpu_image_processing_tpu/server/app.py, after
backend/app.py:115-524), so reference clients (frontend/js/app.js,
test_client.py) work against this server unchanged:

    GET  /                   service info
    GET  /docs               endpoint summary
    GET  /api/health         {"status", "gpu_available"}
    GET  /api/filters        filter catalog with parameter ranges
    GET  /api/stats          request counters, kernel launches, phase times,
                             decode tiers, the runtime's executables, span
                             totals (`spans`), timing brackets (`timing`)
    POST /api/process        one filter, one level (1, 2 or 4)
    POST /api/process-all    level_1 + level_2 comparison (+ optional profiling)
    POST /api/process-batch  many same-size images in one launch per kernel
                             (+ optional profiling)
    POST /api/upload         multipart image file -> base64 PNG

Uploads may be PNG (every bit depth, interlaced or not), JPEG, GIF, BMP,
PSD, HDR, PIC, PNM or TGA (utils/image.py); bytes none of those decoders
reads answer 400.

Degradation contract (app.py:50-68): if the runtime cannot start on its
device, the process endpoints answer 503 and the health check reports it,
but the server still serves.  A level that fails inside process-all is
logged and left out, so the other level can succeed.

Deep profiling (`enable_profiling` on /api/process-all and
/api/process-batch, profiling/profiler.py) merges as the JAX server merges
it (app.py:309-390, 483-513): the profiled time goes under
`ncu_profiled_time_ms`, never over the runtime's `time_ms`, the flattened
keys beside it and the whole profile under `ncu_data`; a profiling failure
sets `profiling_error` and leaves the request's result standing.

Every request to a process endpoint adds its host-clock time in four
phases (decode, run, encode, profile) to `/api/stats` under `phase_ms`.
`timing` counts the runtime's timed brackets and the runs done again
because the card idled inside one (runtime/timing.py).  With ``--spans``
the span recorder (core/spans.py) is on, and `spans` gives each span's
count, ms and self ms: a request's HTTP read, parse, dump and write, its
phases, the codec's base64 and image steps, the runtime's call, bracket
and lock waits and the executables' stage, build, capture, fetch and
eviction; `{}` without it.

Run it with ``python -m gpu_image_processing_tpu_torch.server.app --device
cuda`` (the default), or ``--device cpu`` to ask for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import threading
import time
from typing import Any, Iterator

import numpy as np

from ..core import config, spans
from ..core.params import FILTERS, ValidationError, filters_catalog
from ..ops.cuda import LAUNCHES, build
from ..profiling.profiler import (
    check_profiler_available,
    get_common_metrics,
    profile_batch,
    profile_filter,
)
from ..runtime import timing
from ..runtime.dispatch import FilterRuntime
from ..utils import native_codec
from ..utils.image import (
    ImageCodecError,
    decode_base64_image,
    decode_base64_image_ex,
    decode_png,
    decode_tier_counts,
    encode_image_to_base64,
    encode_png,
    load_image_file,
)
from .http import AppServer, HTTPError, Request, Router
from .schemas import AllLevelsResponse, FilterRequest, FilterResponse, SchemaError

logger = logging.getLogger("gip_torch.server")

API_VERSION = "1.0.0"
PHASES = ("decode", "run", "encode", "profile")


def start_runtime(device: str) -> tuple[FilterRuntime | None, str | None]:
    """(runtime, None) on `device`, or (None, why) if it cannot start."""
    try:
        return FilterRuntime(device), None
    except RuntimeError as exc:
        return None, str(exc)


def warm_kernels(runtime: FilterRuntime) -> None:
    """Build every library and launch every kernel once on a tiny image,
    so the first request does not pay a build.  The launches are eager:
    no executable is built for a shape no request sends."""
    if runtime.device.type == "cuda":
        build.build_all()
    img = np.zeros((8, 8, 3), np.uint8)
    decode_png(encode_png(img))
    native_codec.jpeg_decode(native_codec.jpeg_encode(img))
    for filter_name in FILTERS:
        for level in config.REQUEST_LEVELS:
            runtime.launch_once(filter_name, img, level, radius=2)
    runtime.launch_once("gaussian", img, 4, radius=3)   # the band kernel


class _PhaseTimer:
    """Host-clock milliseconds of one request's phases: decode, run,
    encode and profile.  Each phase is also the span `server.<phase>`
    (core/spans.py), from the same two stamps."""

    def __init__(self) -> None:
        self.ms = dict.fromkeys(PHASES, 0.0)

    @contextlib.contextmanager
    def __call__(self, phase: str) -> Iterator[None]:
        stamps = spans.stamped(f"server.{phase}")
        try:
            with stamps:
                yield
        finally:
            self.ms[phase] += stamps.ms


def _validate_request(req: FilterRequest) -> None:
    if req.filter not in FILTERS:
        raise HTTPError(
            400,
            f"Invalid filter: {req.filter}. Must be 'gaussian', 'box', or 'sobel'",
        )
    if req.level not in config.REQUEST_LEVELS:
        spec = FILTERS[req.filter]
        raise HTTPError(
            400,
            f"Invalid level: {req.level}. {spec.display_name} supports levels "
            f"1 (naive), 2 ({spec.level_names[2]}), or 4 (advanced)",
        )


def _parameters(req: FilterRequest) -> dict[str, Any]:
    return {
        "sigma": req.sigma if req.filter == "gaussian" else None,
        "radius": req.radius if req.filter in ("gaussian", "box") else None,
    }


def _info_dict(req: FilterRequest, level: int, height: int, width: int,
               channels: int, include_level_number: bool = False,
               ) -> dict[str, Any]:
    info = {
        "filter": req.filter,
        "level": FILTERS[req.filter].level_names[level],
        "width": int(width),
        "height": int(height),
        "channels": int(channels),
        "parameters": _parameters(req),
    }
    if include_level_number:
        info["level_number"] = level
    return info


def _filter_kwargs(req: FilterRequest, level: int) -> dict[str, Any]:
    kwargs: dict[str, Any] = {"level": level}
    if req.filter == "gaussian":
        kwargs.update(sigma=req.sigma, radius=req.radius)
    elif req.filter == "box":
        kwargs.update(radius=req.radius)
    return kwargs


def _merge_profile(metrics: dict[str, Any], deep: dict[str, Any]) -> None:
    """The JAX server's merge (app.py:339-360): the profiled time under
    `ncu_profiled_time_ms`, never over the runtime's `time_ms`; the other
    flattened keys beside it; the whole profile under `ncu_data`."""
    common = get_common_metrics(deep, ncu_data=deep)
    if common.get("time_ms", 0) > 0:
        metrics["ncu_profiled_time_ms"] = common["time_ms"]
    metrics.update((k, v) for k, v in common.items() if k != "time_ms")
    metrics["ncu_data"] = deep


def _parse_filter_request(body: Any) -> FilterRequest:
    try:
        return FilterRequest.from_json(body)
    except SchemaError as exc:
        raise HTTPError(422, f"Invalid request: {exc}") from None


def create_app(runtime: FilterRuntime | None = None,
               device: str = "cuda") -> Router:
    """The router of every endpoint, serving from `runtime`, else from a
    runtime started on `device` (the CUDA card unless the caller asks for
    the CPU).  If that runtime cannot start, the process endpoints answer
    503."""
    start_error = None
    if runtime is None:
        runtime, start_error = start_runtime(device)
    available = runtime is not None

    app = Router()
    lock = threading.Lock()   # ThreadingHTTPServer: += is not atomic
    stats: dict[str, Any] = {"started_at": time.time(), "requests_total": 0,
                             "by_route": {}, "phase_ms": {}}

    dispatch = app.dispatch

    def counting_dispatch(request: Request):
        key = f"{request.method} {request.path}"
        with lock:
            stats["requests_total"] += 1
            stats["by_route"][key] = stats["by_route"].get(key, 0) + 1
        return dispatch(request)

    app.dispatch = counting_dispatch

    def record_phases(route: str, timer: _PhaseTimer) -> None:
        with lock:
            totals = stats["phase_ms"].setdefault(
                route, {"requests": 0, **dict.fromkeys(PHASES, 0.0)})
            totals["requests"] += 1
            for phase, ms in timer.ms.items():
                totals[phase] += ms

    def require_runtime() -> FilterRuntime:
        if runtime is None:
            raise HTTPError(
                503, f"GPU filter runtime not available: {start_error}")
        return runtime

    def decode(b64: str, what: str = "") -> np.ndarray:
        try:
            return decode_base64_image(b64)
        except ImageCodecError as exc:
            raise HTTPError(400, f"{what}{exc}") from None

    @app.get("/api/stats")
    def server_stats(_req: Request):
        """Request counters, kernel launches per kernel, the runtime's
        executables and the bytes they hold, per-route host-clock totals
        of each phase, the decode tiers, the span recorder's totals ({}
        unless it is on) and the timing brackets and their reruns."""
        with lock:
            phase_ms = {k: dict(v) for k, v in stats["phase_ms"].items()}
            by_route = dict(stats["by_route"])
            total = stats["requests_total"]
        return 200, {
            "uptime_s": round(time.time() - stats["started_at"], 1),
            "requests_total": total,
            "requests_by_route": by_route,
            "device": str(runtime.device) if available else None,
            "gpu_available": available,
            "kernel_launches": dict(LAUNCHES),
            "executables": (runtime.executables.stats() if available
                            else None),
            "phase_ms": phase_ms,
            "decode_tiers": decode_tier_counts(),
            "spans": spans.totals(),
            "timing": timing.stats(),
        }

    @app.get("/")
    def root(_req: Request):
        return 200, {
            "name": "GPU Image Processing API",
            "version": API_VERSION,
            "status": "running",
            "gpu_available": available,
            "device": str(runtime.device) if available else None,
            "endpoints": {
                "GET /": "This message",
                "GET /api/filters": "List available filters",
                "POST /api/process": "Process image with filter",
                "POST /api/process-all": "Process image at every level",
                "POST /api/process-batch": "Process a batch of images",
                "POST /api/upload": "Upload image, get base64",
                "GET /api/health": "Health check",
            },
        }

    @app.get("/docs")
    def docs(_req: Request):
        return 200, {
            "openapi_like": True,
            "title": "GPU Image Processing API",
            "version": API_VERSION,
            "endpoints": {
                "GET /": {"description": "Service info"},
                "GET /api/health": {"description": "Health check"},
                "GET /api/filters": {
                    "description": "Filter catalog with parameter ranges"
                },
                "GET /api/stats": {
                    "description": "Request counters, kernel launches, "
                                   "executables, decode/run/encode/profile "
                                   "times, decode tiers, span totals "
                                   "(spans; the server's --spans), timing "
                                   "brackets and reruns (timing)"
                },
                "POST /api/process": {
                    "description": "Filter one image at one level",
                    "body": {
                        "image": "base64 or data-URL image: PNG, JPEG, GIF, "
                                 "BMP, PSD, HDR, PIC, PNM or TGA",
                        "filter": "gaussian | box | sobel",
                        "level": "1 (naive) | 2 (optimized) | 4 (advanced)",
                        "sigma": "float, gaussian only, [0.5, 20]",
                        "radius": "int, gaussian/box, [1, 15]",
                    },
                    "returns": "{processed_image, metrics{time_ms,"
                               "bandwidth_gbps,fps}, info}",
                },
                "POST /api/process-all": {
                    "description": "Filter at levels 1 and 2 for comparison",
                    "body": "same as /api/process, plus enable_profiling",
                    "returns": "{original_image, results{level_1,level_2},"
                               " image_info, profiling_available}",
                },
                "POST /api/process-batch": {
                    "description": "Filter a batch of same-size images, one "
                                   "launch per kernel",
                    "body": "{images: [b64,...], filter, level, sigma, "
                            "radius, enable_profiling}",
                },
                "POST /api/upload": {
                    "description": "multipart/form-data image file (PNG, "
                                   "JPEG, GIF, BMP, PSD, HDR, PIC, PNM or "
                                   "TGA) -> base64 PNG"
                },
            },
        }

    @app.get("/api/health")
    def health(_req: Request):
        return 200, {"status": "healthy", "gpu_available": available}

    @app.get("/api/filters")
    def list_filters(_req: Request):
        return 200, {"filters": filters_catalog(), "gpu_available": available}

    @app.post("/api/process")
    def process_image(request: Request):
        rt = require_runtime()
        if request.json is None:
            raise HTTPError(400, "Expected a JSON body")
        req = _parse_filter_request(request.json)
        _validate_request(req)
        timer = _PhaseTimer()
        with timer("decode"):
            img = decode(req.image)
        height, width, channels = img.shape
        try:
            with timer("run"):
                out, metrics = rt.run(req.filter, img,
                                      **_filter_kwargs(req, req.level))
            with timer("encode"):
                encoded = encode_image_to_base64(out)
        except ValidationError as exc:
            raise HTTPError(400, str(exc)) from None
        except Exception as exc:
            raise HTTPError(500, f"Processing failed: {exc}") from None
        record_phases("POST /api/process", timer)
        return 200, FilterResponse(
            processed_image=encoded,
            metrics=metrics.as_dict(),
            info=_info_dict(req, req.level, height, width, channels),
        ).as_dict()

    @app.post("/api/process-all")
    def process_all_levels(request: Request):
        rt = require_runtime()
        if request.json is None:
            raise HTTPError(400, "Expected a JSON body")
        req = _parse_filter_request(request.json)
        if req.filter not in FILTERS:
            raise HTTPError(
                400,
                f"Invalid filter: {req.filter}. Must be 'gaussian', 'box', or 'sobel'",
            )
        timer = _PhaseTimer()
        with timer("decode"):
            try:
                img, passthrough = decode_base64_image_ex(req.image)
            except ImageCodecError as exc:
                raise HTTPError(400, str(exc)) from None
        height, width, channels = img.shape
        # A rendering-neutral RGB PNG or baseline JPEG upload passes through
        # as the original instead of paying a full PNG encode.
        with timer("encode"):
            original = passthrough or encode_image_to_base64(img)
        profiling = (req.enable_profiling
                     and check_profiler_available(rt.device))

        results: dict[str, FilterResponse] = {}
        prev_out, prev_encoded = None, None
        for level in config.VALID_LEVELS:
            try:
                with timer("run"):
                    out, run_metrics = rt.run(req.filter, img,
                                              **_filter_kwargs(req, level))
                metrics = run_metrics.as_dict()
                if profiling:
                    with timer("profile"):
                        try:
                            _merge_profile(metrics, profile_filter(
                                rt, img, req.filter, level,
                                **_parameters(req)))
                        except Exception as exc:
                            logger.exception("Profiling failed for level %s",
                                             level)
                            metrics["profiling_error"] = str(exc)
                with timer("encode"):
                    # Gaussian and box levels are bit-identical: reuse the
                    # previous level's PNG when the pixels match.
                    if prev_encoded is not None and np.array_equal(out, prev_out):
                        encoded = prev_encoded
                    else:
                        encoded = encode_image_to_base64(out)
                        prev_out, prev_encoded = out, encoded
                results[f"level_{level}"] = FilterResponse(
                    processed_image=encoded,
                    metrics=metrics,
                    info=_info_dict(req, level, height, width, channels,
                                    include_level_number=True),
                )
            except Exception:
                logger.exception("Error processing level %s", level)
        if not results:
            raise HTTPError(500, "Failed to process image with any optimization level")
        record_phases("POST /api/process-all", timer)
        return 200, AllLevelsResponse(
            original_image=original,
            results=results,
            image_info={
                "width": int(width),
                "height": int(height),
                "channels": int(channels),
                "filter": req.filter,
                "parameters": _parameters(req),
            },
            profiling_available=profiling,
        ).as_dict()

    @app.post("/api/process-batch")
    def process_batch(request: Request):
        """Many same-size images, one launch per kernel.  Body:
        {"images": [b64,...], "filter": ..., "level": 1|2|4, "sigma": f,
        "radius": n}."""
        rt = require_runtime()
        body = request.json
        if (not isinstance(body, dict) or not isinstance(body.get("images"), list)
                or not body["images"]):
            raise HTTPError(400, "Expected a JSON body with a non-empty 'images' list")
        fields = {k: v for k, v in body.items() if k != "images"}
        fields["image"] = body["images"][0]
        req = _parse_filter_request(fields)
        _validate_request(req)
        timer = _PhaseTimer()
        with timer("decode"):
            decoded = [decode(b64, f"Image {idx}: ")
                       for idx, b64 in enumerate(body["images"])]
        shapes = {arr.shape for arr in decoded}
        if len(shapes) != 1:
            raise HTTPError(
                400,
                f"All images in a batch must share one shape; got {sorted(shapes)}",
            )
        batch = np.stack(decoded)
        height, width, channels = batch.shape[1:]
        try:
            with timer("run"):
                out, metrics = rt.run_batch(req.filter, batch,
                                            **_filter_kwargs(req, req.level))
        except ValidationError as exc:
            raise HTTPError(400, str(exc)) from None
        except Exception as exc:
            raise HTTPError(500, f"Processing failed: {exc}") from None
        merged = {**metrics.as_dict(), "batch_size": int(batch.shape[0]),
                  "images_per_second": metrics.fps}
        if req.enable_profiling:
            with timer("profile"):
                try:
                    _merge_profile(merged, profile_batch(
                        rt, batch, req.filter, req.level,
                        **_parameters(req)))
                except Exception as exc:
                    logger.exception("Batch profiling failed")
                    merged["profiling_error"] = str(exc)
        with timer("encode"):
            images = [encode_image_to_base64(img) for img in out]
        record_phases("POST /api/process-batch", timer)
        return 200, {
            "processed_images": images,
            "metrics": merged,
            "info": _info_dict(req, req.level, height, width, channels),
        }

    @app.post("/api/upload")
    def upload_image(request: Request):
        if "file" not in request.files:
            raise HTTPError(400, "Upload failed: no file field in request")
        _, data = request.files["file"]
        try:
            arr, width, height = load_image_file(data)
        except ImageCodecError as exc:
            raise HTTPError(400, f"Upload failed: {exc}") from None
        except Exception as exc:
            raise HTTPError(500, f"Upload failed: {exc}") from None
        return 200, {
            "base64_image": encode_image_to_base64(
                arr if arr.shape[2] != 1 else arr[:, :, 0]),
            "width": width,
            "height": height,
            "channels": arr.shape[2],
        }

    return app


def main(argv: list[str] | None = None) -> None:
    """Server entry point (uvicorn __main__ analog, app.py:526-543)."""
    import signal

    parser = argparse.ArgumentParser(description="GPU Image Processing API Server")
    parser.add_argument("--host", default=config.BACKEND_HOST)
    parser.add_argument("--port", type=int, default=config.BACKEND_PORT)
    parser.add_argument("--device", default="cuda",
                        help="device to serve from: cuda (default) or cpu")
    parser.add_argument("--spans", action="store_true",
                        help="record spans of the host work; /api/stats "
                             "gives their totals under spans")
    args = parser.parse_args(argv)
    if args.spans:
        spans.enable()

    logging.basicConfig(level=logging.INFO)
    runtime, error = start_runtime(args.device)
    print("=" * 70)
    print("GPU Image Processing API Server")
    print("=" * 70)
    print(f"Device: {runtime.device if runtime else args.device} "
          f"(available: {runtime is not None}{'' if runtime else ', ' + error})")
    if runtime is not None:
        t0 = time.perf_counter()
        warm_kernels(runtime)
        print(f"Kernels built and launched once in "
              f"{time.perf_counter() - t0:.1f} s")
    print(f"\nStarting server on http://{args.host}:{args.port}")
    print("=" * 70 + "\n")

    server = AppServer(create_app(runtime, args.device), args.host, args.port)

    def stop(_sig, _frame):
        # shutdown() blocks until serve_forever returns: not on this thread.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)
    server.serve_forever()


if __name__ == "__main__":
    main()
