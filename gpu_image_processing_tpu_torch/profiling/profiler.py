"""Deep profiling on torch.profiler: the port of the JAX package's
profiling/profiler.py, which replaced the reference's Nsight Compute
sidecar (backend/profiling/ncu_profiler.py).

The same contract:

(a) the primary ``time_ms`` is always the runtime's own timing (CUDA events
    around the card's work); profiled numbers never override it: the
    server puts the profiled time under ``ncu_profiled_time_ms``
    (backend/app.py:391-427);
(b) `profile_filter` and `profile_batch` return the categorized dict the
    ncu parser produced: {"execution", "memory", "occupancy", "config",
    "total_kernel_duration_ms", "kernels_profiled", ...};
(c) `get_common_metrics` flattens it to the UI's keys (`time_ms`,
    `memory_throughput_gbps`, `dram_throughput_pct`, `kernel_durations`,
    `total_kernels`, ...) like ncu_profiler.get_common_ncu_metrics
    (:795-934).

The duration tiers:

* on a CUDA device, ``torch_profiler_trace``: `torch.profiler` with CUDA
  activity around `PROFILE_REPS` runs of the call the runtime serves (the
  rows function, or on a mesh deployment the row-sharded or mesh-batch
  call, ``Serving Path`` ``spatial(sp=n)`` or ``batch(dp=n)``) on the
  image already on the card; each device row (a kernel, or a copy or fill
  if the function issued one) becomes an entry of `kernel_durations_ms`
  under its own name, its device time a call (`_trace_kernels`);
* on the CPU, ``wall_timing``: the host clock around the same runs, which
  serve the kernels' plain versions.

What is not reported, and why (each reason also stands in ``config``):

* occupancy: achieved occupancy is an Nsight Compute counter, which
  `torch.profiler` does not read, so ``occupancy`` stays empty;
* per-pass durations: every kernel of the port runs both passes of a
  separable blur in one launch, so no launch boundary separates them.

Utilization percentages are computed only against the published peaks of a
card in `PEAKS`, keyed by `torch.cuda.get_device_name()`; any other card,
and the CPU, get none.
"""

from __future__ import annotations

import tempfile
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.params import normalize_level
from ..runtime.dispatch import FilterRuntime
from .traffic import BYTES_SOURCE, io_bytes, served_tensor_core_flops


class DevicePeaks(NamedTuple):
    """Device memory bytes a second; float32 operations a second outside
    the tensor cores, one instruction an operation (the kernels build with
    -fmad=false, so a multiply-add is two); dense bf16 tensor-core
    operations a second."""

    hbm_bytes_per_s: float
    f32_ops_per_s: float
    bf16_tensor_ops_per_s: float


#: Published peaks of each known card at its full power limit.  H100 SXM
#: (700 W): 3.35 TB/s of HBM3, 132 SMs x 128 float32 lanes x 1.98 GHz,
#: 989e12 dense bf16 tensor-core operations a second.
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(3.35e12, 132 * 128 * 1.98e9, 989e12),
}

#: Runs of the served function inside one profile.  On the card, late in a
#: long-lived process, a trace kept only some launches of the hand kernels
#: (2 of 4), so a profile takes ten and rates each row by its launches.
PROFILE_REPS = 10
_SESSION_LOCK = threading.Lock()

OCCUPANCY_NOTE = ("not measured: achieved occupancy is an Nsight Compute "
                  "counter, which torch.profiler does not read")
PER_PASS_NOTE = ("absent: every kernel runs both passes of a separable blur "
                 "in one launch, so no launch boundary separates them")


def device_peaks(device_name: Optional[str]) -> Optional[DevicePeaks]:
    """The peaks of the card named `device_name`, or None (an unknown card,
    or the CPU): callers then omit utilization percentages rather than
    compute them against a wrong peak."""
    return PEAKS.get(device_name) if device_name else None


def check_profiler_available(device: torch.device | str = "cuda") -> bool:
    """Analog of check_ncu_available (ncu_profiler.py:25): on a CUDA device,
    whether torch.profiler can trace CUDA activity; on the CPU the wall
    timing tier is always there."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    return (torch.cuda.is_available() and torch.profiler.ProfilerActivity.CUDA
            in torch.profiler.supported_activities())


def _kernel_label(filter_type: str, level: int) -> str:
    names = {
        ("gaussian", 1): "gaussian_blur_oracle_l1",
        ("gaussian", 2): "gaussian_blur_fused_l2",
        ("box", 1): "box_blur_oracle_l1",
        ("box", 2): "box_blur_fused_l2",
        ("sobel", 1): "sobel_oracle_l1",
        ("sobel", 2): "sobel_fused_l2",
    }
    return names.get((filter_type, level), f"{filter_type}_l{level}")


def _defaults(filter_type: str, sigma: Optional[float],
              radius: Optional[int]) -> tuple[float, int]:
    return (2.0 if sigma is None else sigma), (3 if radius is None else radius)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def short_kernel_name(full: str) -> str:
    """A trace row's name without "void ", anonymous namespaces and the
    argument list, cut to 70 characters: the label a person reads."""
    name = full.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i].rstrip()
            break
    return name if len(name) <= 70 else name[:67] + "..."


def _trace_kernels(prof, reps: int) -> dict[str, dict[str, float]]:
    """{name: {count, total_ms, avg_ms, per_call_ms}} of every device row of
    a trace of `reps` calls.  A row's time a call is its mean launch time
    times its launches a call (count / reps, rounded), so a launch the
    trace missed does not shrink it."""
    rows = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total_ms = e.device_time_total / 1000.0
        if total_ms > 0:
            avg_ms = total_ms / max(e.count, 1)
            rows[e.key] = {"count": e.count, "total_ms": total_ms,
                           "avg_ms": avg_ms,
                           "per_call_ms": avg_ms * max(1, round(e.count / reps))}
    return rows


def _measure(devices: tuple[torch.device, ...], run: Callable[[], Any],
             reps: int) -> tuple[list[float], Optional[dict], Optional[int]]:
    """(times_ms, trace rows, peak device bytes) of `reps` runs of `run`,
    whose first call has been made, on `devices` (one, or a mesh's)."""
    if devices[0].type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1000.0)
        return times, None, None
    from torch.profiler import ProfilerActivity, profile

    # One session at a time: torch.profiler allows one in a process, and its
    # trace holds the whole device's activity.
    with _SESSION_LOCK:
        for device in devices:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            for device in devices:
                torch.cuda.synchronize(device)
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    kernels = _trace_kernels(prof, reps)
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity on "
                           f"{', '.join(map(str, devices))}")
    per_call = sum(k["per_call_ms"] for k in kernels.values())
    return [per_call] * reps, kernels, peak


def _assemble(*, device: torch.device, times_ms: list[float],
              kernels: Optional[dict], peak_bytes: Optional[int], reps: int,
              label: str, shape: tuple[int, ...], tensor_flops: Optional[int],
              extra_config: dict[str, Any]) -> dict[str, Any]:
    """The categorized dict shared by profile_filter and profile_batch."""
    duration_ms = min(times_ms)
    seconds = max(duration_ms, 1e-9) / 1000.0
    image_bytes = io_bytes(*shape) // 2
    io_gbps = io_bytes(*shape) / seconds / 1e9
    name = _device_name(device)
    metrics: dict[str, Any] = {
        "execution": {
            "Duration (ms)": duration_ms,
            "Mean Duration (ms)": float(np.mean(times_ms)),
            "Launch Count": reps,
        },
        "memory": {
            "Memory Throughput (Gbyte/s)": io_gbps,
            "IO Throughput (Gbyte/s)": io_gbps,
            "Peak Device Memory (bytes)": peak_bytes,
            "Argument Bytes": image_bytes,
            "Output Bytes": image_bytes,
        },
        "occupancy": {},
        "config": {
            "Image Shape": "x".join(map(str, shape)),
            "Platform": device.type,
            "Device": name,
            "Occupancy": OCCUPANCY_NOTE,
            "Per-Pass Durations": PER_PASS_NOTE,
            **extra_config,
        },
        "total_kernel_duration_ms": duration_ms,
        "kernels_profiled": [label],
        "bytes_source": BYTES_SOURCE,
    }
    peaks = device_peaks(name if device.type == "cuda" else None)
    if peaks is not None:
        # Against the image's floor bytes (read once, written once), which
        # any implementation moves.
        metrics["memory"]["DRAM Throughput (% of peak)"] = (
            100.0 * io_gbps * 1e9 / peaks.hbm_bytes_per_s)
        metrics["config"]["Peak HBM Bandwidth (Gbyte/s)"] = (
            peaks.hbm_bytes_per_s / 1e9)
        if tensor_flops:
            metrics["execution"][
                "Tensor Core Throughput (% of bf16 peak, modeled)"] = (
                100.0 * tensor_flops / seconds / peaks.bf16_tensor_ops_per_s)
            metrics["config"]["Modeled Tensor Core FLOPs"] = tensor_flops
    else:
        metrics["config"]["Peak Table"] = (
            f"no trusted peak table for {name!r}: utilization percentages "
            f"omitted")
    if kernels:
        names = sorted(kernels, key=lambda n: -kernels[n]["total_ms"])
        metrics["kernels_profiled"] = names
        metrics["kernel_durations_ms"] = {
            n: kernels[n]["per_call_ms"] for n in names}
        metrics["trace_kernel_stats"] = kernels
        metrics["trace_total_ms"] = duration_ms
        metrics["duration_source"] = "torch_profiler_trace"
        metrics["profiler"] = "torch_profiler"
        # The execution rows carry short labels (the full names, whole
        # signatures, stay in kernel_durations_ms); two that shorten alike
        # keep their full names.
        shorts = [short_kernel_name(n) for n in names]
        for n, short in zip(names, shorts):
            label = short if shorts.count(short) == 1 else n
            metrics["execution"][f"Duration {label} (ms)"] = (
                metrics["kernel_durations_ms"][n])
    else:
        metrics["duration_source"] = "wall_timing"
        metrics["profiler"] = "wall_clock"
    return metrics


def _profile(runtime: FilterRuntime, images: np.ndarray, filter_type: str,
             level: int, sigma: Optional[float], radius: Optional[int],
             batch: Optional[int], label: str) -> dict[str, Any]:
    """Profile the call the runtime serves for the request: the same
    prepared call (row-sharded or mesh-batched where the runtime's
    switches route it), with its operands on the device(s) already."""
    sigma, radius = _defaults(filter_type, sigma, radius)
    height, width, channels = images.shape[-3:]
    if batch:
        call = runtime._batch_call(filter_type, images, level, sigma, radius)
    else:
        call = runtime._single_call(filter_type, images, level, sigma, radius)
    call.run()   # builds and warms, untimed
    times, kernels, peak = _measure(call.devices, call.run, PROFILE_REPS)
    flops = served_tensor_core_flops(filter_type, call.level, height, width,
                                     channels, radius, batch or 1)
    extra = ({"Serving Path": call.path, "Batch Size": batch} if batch
             else {"Serving Path": call.path})
    return _assemble(device=call.devices[0], times_ms=times, kernels=kernels,
                     peak_bytes=peak, reps=PROFILE_REPS, label=label,
                     shape=tuple(images.shape), tensor_flops=flops,
                     extra_config=extra)


def profile_filter(runtime: FilterRuntime, image: np.ndarray, filter_type: str,
                   level: int, sigma: Optional[float] = None,
                   radius: Optional[int] = None) -> dict[str, Any]:
    """Profile one filter on one (H, W, C) image as `runtime` serves it: the
    rows function on its device, or on a row-sharded deployment
    (``GIP_TPU_MESH_SPATIAL=1``) the sharded call, ``Serving Path``
    ``spatial(sp=n)``."""
    lvl = normalize_level(filter_type, level)
    return _profile(runtime, image, filter_type, level, sigma, radius, None,
                    _kernel_label(filter_type, lvl))


def profile_batch(runtime: FilterRuntime, images: np.ndarray, filter_type: str,
                  level: int, sigma: Optional[float] = None,
                  radius: Optional[int] = None) -> dict[str, Any]:
    """Profile the batched path (/api/process-batch) on a (B, H, W, C) stack:
    the one launch a kernel that `FilterRuntime.run_batch` serves, or with
    ``GIP_TPU_MESH_BATCH=1`` one a device (``Serving Path`` ``batch(dp=n)``)."""
    lvl = normalize_level(filter_type, level)
    return _profile(runtime, images, filter_type, level, sigma, radius,
                    int(images.shape[0]), f"{filter_type}_batch_l{lvl}")


def capture_trace(fn: Callable[[], Any], device: torch.device | str,
                  trace_dir: Optional[str] = None) -> str:
    """A torch.profiler trace of `fn()` written as a Chrome trace
    (``trace.json``) into `trace_dir` (a new temporary directory if None),
    which is kept for offline reading; returns the directory."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir = trace_dir or tempfile.mkdtemp(prefix="gip_torch_trace_")
    with _SESSION_LOCK, profile(activities=activities) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(f"{out_dir}/trace.json")
    return out_dir


def get_common_metrics(metrics: dict[str, Any],
                       ncu_data: Optional[dict] = None) -> dict[str, Any]:
    """Flatten the categorized dict to the UI's keys, as the JAX package's
    get_common_metrics does (the same output keys as get_common_ncu_metrics,
    ncu_profiler.py:795-934)."""
    if not metrics or not isinstance(metrics, dict):
        return {}
    common: dict[str, Any] = {}

    occ = metrics.get("occupancy", {})
    for key, value in occ.items():
        if "occupancy" in key.lower() and isinstance(value, (int, float)):
            common["occupancy_pct"] = float(value)

    mem = metrics.get("memory", {})
    for key, value in mem.items():
        if not isinstance(value, (int, float)):
            continue
        kl = key.lower()
        if "memory throughput" in kl:
            common["memory_throughput_gbps"] = float(value)
        elif "dram throughput" in kl:
            common["dram_throughput_pct"] = float(value)
        elif "peak device memory" in kl:
            common["peak_device_memory_bytes"] = float(value)

    ex = metrics.get("execution", {})
    for key, value in ex.items():
        if not isinstance(value, (int, float)):
            continue
        kl = key.lower()
        if kl.startswith("duration") and "pass" not in kl:
            common.setdefault("kernel_durations", []).append(float(value))
        elif "compute throughput" in kl:
            common["compute_throughput_pct"] = float(value)

    source = (ncu_data if (ncu_data and "total_kernel_duration_ms" in ncu_data)
              else metrics)
    if "kernel_durations_ms" in source:
        common["kernel_durations"] = [
            float(v) for v in source["kernel_durations_ms"].values()]
    if "duration_source" in source:
        common["kernel_duration_source"] = source["duration_source"]
    if "total_kernel_duration_ms" in source:
        common["time_ms"] = source["total_kernel_duration_ms"]
        common["kernel_duration_ms"] = source["total_kernel_duration_ms"]
        if "kernels_profiled" in source:
            common["kernels_profiled"] = source["kernels_profiled"]
            common["total_kernels"] = len(source["kernels_profiled"])
    elif "kernel_durations" in common:
        common["time_ms"] = sum(common["kernel_durations"])
        common["kernel_duration_ms"] = common["time_ms"]
        common["total_kernels"] = len(common["kernel_durations"])

    return common
