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
  rows function, its graph's replay once captured, or on a mesh
  deployment the row-sharded or mesh-batch
  call, ``Serving Path`` ``spatial(sp=n)`` or ``batch(dp=n)``) on the
  image already on the card; each device row (a kernel, or a copy or fill
  if the function issued one) becomes an entry of `kernel_durations_ms`
  under its own name, its device time over the runs (`_trace_kernels`).
  A session (`traced`) first spends device records on `PRIMERS` spins and
  `SESSION_LEAD_S` of host time, which no table rates: torch.profiler lost
  a session's first device records, by count in the threaded server and by
  time elsewhere (PERF.md, section 7).  The trace must hold every
  hand-kernel launch that `ops.cuda.LAUNCHES` counted during it
  (`check_launches`); else the profile opens another session with twice
  the lead and four times the primers, and after `SESSION_ATTEMPTS` it
  raises, naming both counts;
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

import contextlib
import tempfile
import threading
import time
from collections import Counter
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.params import normalize_level
from ..ops.cuda import LAUNCHES
from ..runtime.dispatch import FilterRuntime
from ..runtime.timing import exclusive
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

#: Runs of the served function inside one profile.
PROFILE_REPS = 10
#: Spins (`torch.cuda._sleep`, kernel `PRIMER_KERNEL`) that open every
#: session, then host time before its work.  torch.profiler drops the device
#: records it dates before its session's window (Kineto's "Out-of-range"),
#: and on an H100 a session's first records were so dated: those of its
#: first milliseconds (1 session in 40 to 160 without the lead), or its
#: first 4 whatever the host time (the threaded server's sessions); PERF.md,
#: section 7.  A session opened again has twice the lead and four times
#: the primers: once the threaded server had run, a session of the main
#: thread lost its first record, and late in a long run every primer and
#: then 1 to 3 launches, at a lead of 80 ms as at 20.
PRIMERS = 16
PRIMER_KERNEL = "spin_kernel"
SESSION_LEAD_S = 0.02
#: Sessions a profile opens at most while its trace misses a launch.
SESSION_ATTEMPTS = 3
_SESSION_LOCK = threading.Lock()
#: The hand kernels as a trace names them (ops/cuda/*.cu).  Each launch
#: that `ops.cuda.LAUNCHES` counts launches one of them; `box_rows` past
#: r = 64 launches `box_wide_v` after `box_wide_h`.
HAND_KERNELS = ("gauss_window_rows", "gauss_pair_rows", "box_window_rows",
                "box_wide_h", "band_mma_rows", "sobel_tile_rows")
SECOND_KERNEL = ("box_wide_v", "box_wide_h")

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


def _trace_kernels(averages, reps: int) -> dict[str, dict[str, float]]:
    """{name: {count, total_ms, avg_ms, per_call_ms}} of every device row of
    a trace's `key_averages()` of `reps` calls but the session's primers; a
    row's time a call is its device time over the calls."""
    rows = {}
    for e in averages:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or PRIMER_KERNEL in e.key):
            continue
        total_ms = e.device_time_total / 1000.0
        if total_ms > 0:
            rows[e.key] = {"count": e.count, "total_ms": total_ms,
                           "avg_ms": total_ms / max(e.count, 1),
                           "per_call_ms": total_ms / reps}
    return rows


def traced_launches(kernels: dict[str, dict[str, float]]) -> Counter:
    """Launches of each hand kernel (`HAND_KERNELS`, `box_wide_v`) in the
    trace rows `kernels` (`_trace_kernels`)."""
    counts: Counter = Counter()
    for name, row in kernels.items():
        base = short_kernel_name(name).split("<")[0]
        if base in (*HAND_KERNELS, SECOND_KERNEL[0]):
            counts[base] += row["count"]
    return counts


class LostLaunches(RuntimeError):
    """A trace that misses launches of the hand kernels."""


def check_launches(kernels: dict[str, dict[str, float]], made: int) -> None:
    """Raise unless the trace rows `kernels` hold every hand-kernel launch
    of the session, `made` as `ops.cuda.LAUNCHES` counted them: a table
    that misses launches is not rated."""
    counts = traced_launches(kernels)
    traced = sum(n for k, n in counts.items() if k != SECOND_KERNEL[0])
    second, first = (counts[k] for k in SECOND_KERNEL)
    if traced != made or second != first:
        raise LostLaunches(
            f"the trace holds {traced} hand-kernel launches where {made} were "
            f"made (ops.cuda.LAUNCHES; by kernel: {dict(counts)}): not rated")


def primers_kept(averages) -> int:
    """The primers of a `traced` session that its trace's `key_averages()`
    kept."""
    return sum(e.count for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and PRIMER_KERNEL in e.key)


@contextlib.contextmanager
def traced(devices: Sequence[torch.device], lead_s: float = SESSION_LEAD_S,
           primers: int = PRIMERS):
    """A torch.profiler session with CPU and CUDA activity that keeps the
    block's device work: it opens with `primers` spins on each device's
    current stream and `lead_s` of host time, and closes once the devices
    have finished the block.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for device in devices:
            with torch.cuda.device(device):
                for _ in range(primers):
                    torch.cuda._sleep(1)
        time.sleep(lead_s)
        yield prof
        for device in devices:
            torch.cuda.synchronize(device)


def _measure(devices: tuple[torch.device, ...], run: Callable[[], Any],
             reps: int) -> tuple[list[float], Optional[dict], Optional[int],
                                 dict[str, Any]]:
    """(times_ms, trace rows, peak device bytes, the trace's account for
    ``config``) of `reps` runs of `run`, whose first call has been made, on
    `devices` (one, or a mesh's).  On the card, a session whose trace
    missed a launch is opened again with twice the lead and four times
    the primers, `SESSION_ATTEMPTS` times at most; then the last one's
    `LostLaunches` is raised."""
    if devices[0].type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1000.0)
        return times, None, None, {}
    for attempt in range(1, SESSION_ATTEMPTS + 1):
        lead_s = SESSION_LEAD_S * 2 ** (attempt - 1)
        primers = PRIMERS * 4 ** (attempt - 1)
        kernels, made, peak, kept = _session(devices, run, reps, lead_s,
                                             primers)
        try:
            check_launches(kernels, made)
            break
        except LostLaunches as exc:
            if attempt == SESSION_ATTEMPTS:
                raise LostLaunches(
                    f"{exc}, in each of {attempt} sessions (the last with a "
                    f"{lead_s * 1e3:g} ms lead, {kept} of "
                    f"{primers * len(devices)} primers kept)")
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity on "
                           f"{', '.join(map(str, devices))}")
    per_call = sum(k["per_call_ms"] for k in kernels.values())
    account = {"Trace Sessions": attempt,
               "Trace Primers Kept": f"{kept} of {primers * len(devices)}"}
    return [per_call] * reps, kernels, peak, account


def _session(devices: tuple[torch.device, ...], run: Callable[[], Any],
             reps: int, lead_s: float,
             primers: int) -> tuple[dict, int, int, int]:
    """(trace rows, hand-kernel launches made, peak device bytes, primers
    kept) of one traced session of `reps` runs of `run` on the cards,
    opened with `primers` spins a card and a lead of `lead_s`."""
    # One session at a time: torch.profiler allows one in a process, and its
    # trace holds the whole device's activity, so no other request's device
    # work may run meanwhile (runtime/timing.py::exclusive).
    with _SESSION_LOCK, exclusive(devices):
        for device in devices:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        made = sum(LAUNCHES.values())
        with traced(devices, lead_s, primers) as prof:
            for _ in range(reps):
                run()
        made = sum(LAUNCHES.values()) - made
        peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    averages = prof.key_averages()
    return (_trace_kernels(averages, reps), made, peak,
            primers_kept(averages))


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
    # The served call: on one device its executable, held, built if need
    # be, with the request's rows staged, so the session traces the runs
    # that serve the request (the graph's replays once it is captured).
    # One untimed run first, holding the card as the runtime's
    # own first run does (runtime/dispatch.py::_timed): never inside
    # another request's bracket.  Released before _measure, which takes the
    # session lock first.
    with call.staged():
        with exclusive(call.devices):
            call.run()
        times, kernels, peak, account = _measure(call.devices, call.run,
                                                 PROFILE_REPS)
    flops = served_tensor_core_flops(filter_type, call.level, height, width,
                                     channels, radius, batch or 1)
    extra = ({"Serving Path": call.path, "Batch Size": batch} if batch
             else {"Serving Path": call.path})
    extra.update(account)
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
    out_dir = trace_dir or tempfile.mkdtemp(prefix="gip_torch_trace_")
    with _SESSION_LOCK, (traced([device]) if device.type == "cuda" else
                         profile(activities=[ProfilerActivity.CPU])) as prof:
        fn()
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
