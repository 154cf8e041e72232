"""One route from a filter call to its kernel (`ops/cuda/api.py`).

For every filter, level, radius and channel count, each caller runs the
wrapper that `rows_function` names for the level the caller serves: the
runtime (`FilterRuntime.run`) its normalized level; a module's `forward`
level 1, or level 2 at levels 2 and 4 (the JAX `apply`); the batch filter
that, but Sobel at its own level (the JAX batch filter's grey rule); the
tier its level.  The profiler's model counts tensor-core work exactly where
the route names the band.  On the CPU every wrapper serves its plain
version, so the wrappers are recorded, not the kernels.
"""

import itertools
from collections import Counter

import pytest
import torch

from gpu_image_processing_tpu_torch.models.filters import get_filter
from gpu_image_processing_tpu_torch.ops import interleaved
from gpu_image_processing_tpu_torch.ops.cuda import (
    LAUNCHES,
    api,
    blur,
    blur_planar,
    sobel,
)
from gpu_image_processing_tpu_torch.ops.weights import gaussian_kernel_f32
from gpu_image_processing_tpu_torch.parallel.batch import make_batch_filter
from gpu_image_processing_tpu_torch.parallel.mesh import make_mesh
from gpu_image_processing_tpu_torch.profiling import traffic
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime

from .conftest import make_image

CPU = torch.device("cpu")
SIGMA = 2.0
WRAPPERS = [(mod, name) for mod in (interleaved, blur, sobel)
            for name in ("gaussian_rows", "gaussian_folded_rows",
                         "gaussian_band_rows", "box_rows", "sobel_rows",
                         "sobel_f32_rows") if hasattr(mod, name)]
WRAPPERS += [(blur_planar, n) for n in ("gaussian_planar",
                                        "gaussian_folded_planar", "box_planar")]

CASES = [(f, lv, r, c) for f, radii in (("gaussian", (1, 2, 3, 15)),
                                        ("box", (1, 2, 3, 15, 70)),
                                        ("sobel", (3,)))
         for lv, r, c in itertools.product((1, 2, 4), radii, (1, 3, 4))]


def _record(monkeypatch, calls: list) -> None:
    """Record the outermost wrapper each call runs, as `module.name`, with
    the shape of its first argument: a plain version that calls another
    wrapper is not recorded again."""
    depth = [0]
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)
        label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            if not depth[0]:
                calls.append((_label, tuple(args[0].shape)))
            depth[0] += 1
            try:
                return _fn(*args, **kwargs)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(mod, name, wrapped)


def _ran(fn, calls) -> tuple[str, tuple]:
    """The one wrapper, and the one shape, that `fn()` runs."""
    calls.clear()
    fn()
    (call,) = set(calls)
    return call


def _named(filter_name, level, radius, channels, width, taps, calls) -> str:
    """The wrapper the route's function for `level` runs."""
    rows = torch.zeros(2, 3, width * channels, dtype=torch.uint8)
    fn = api.rows_function(filter_name, level, radius, channels, width, taps,
                           CPU)
    return _ran(lambda: fn(rows), calls)[0]


@pytest.mark.parametrize("filter_name,level,radius,channels", CASES)
def test_every_caller_runs_the_routed_wrapper(rng, monkeypatch, filter_name,
                                              level, radius, channels):
    h, w = 9, 11
    img = make_image(rng, h, w, channels)
    imgs = torch.from_numpy(make_image(rng, 2 * h, w, channels)).view(2, h, w,
                                                                      channels)
    taps = (gaussian_kernel_f32(radius, SIGMA) if filter_name == "gaussian"
            else None)
    calls: list = []
    _record(monkeypatch, calls)

    def named(lv):
        return _named(filter_name, lv, radius, channels, w, taps, calls)

    params = {"gaussian": {"sigma": SIGMA, "radius": radius},
              "box": {"radius": radius}, "sobel": {}}[filter_name]
    module = get_filter(filter_name, level=level, **params)
    batch = make_batch_filter(make_mesh(2, dp=2, sp=1, devices=["cpu"] * 2),
                              filter_name, radius=radius, level=level)
    forward_level = 1 if level == 1 else 2
    batch_level = level if filter_name == "sobel" else forward_level
    served = {
        "runtime": (lambda: FilterRuntime(CPU).run(filter_name, img, level,
                                                   SIGMA, radius), level),
        "forward": (lambda: module(torch.from_numpy(img)), forward_level),
        "batch": (lambda: batch(imgs, *([taps] if taps is not None else [])),
                  batch_level),
        "tier": (lambda: api.filtered(torch.from_numpy(img), filter_name,
                                      level, radius, taps), level),
    }
    ran = {caller: _ran(fn, calls) for caller, (fn, _) in served.items()}
    want = {caller: named(lv) for caller, (_, lv) in served.items()}
    assert {caller: name for caller, (name, _) in ran.items()} == want
    band = named(level) == "blur.gaussian_band_rows"
    flops = traffic.served_tensor_core_flops(filter_name, level, h, w,
                                             channels, radius)
    assert (flops is not None) == band
    # The tier runs the band on the planes, one channel; the runtime and
    # every other function of the tier on the interleaved rows.
    assert ran["runtime"][1] == (h, w * channels)
    assert ran["tier"][1] == ((channels, h, w) if band else (h, w * channels))


# -- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("filter_name,level,radius", [
    (f, lv, r) for f, radii in (("gaussian", (2, 15)), ("box", (5, 70)),
                                ("sobel", (3,)))
    for lv in (1, 2, 4) for r in radii])
def test_every_caller_launches_the_routed_kernels_on_the_card(
        rng, filter_name, level, radius):
    # The runtime's eager run, forward, the batch filter on a one-card mesh
    # and the tier launch on the card what the route's function for their
    # level launches, counted by wrapper (level 1 launches none of the
    # hand-written kernels).
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    dev = torch.device("cuda")
    h, w, c = 61, 97, 3
    img = make_image(rng, h, w, c)
    frame = torch.from_numpy(img).to(dev)
    taps = (gaussian_kernel_f32(radius, SIGMA) if filter_name == "gaussian"
            else None)

    def launched(fn) -> Counter:
        before = LAUNCHES.copy()
        fn()
        torch.cuda.synchronize()
        return LAUNCHES - before

    def routed(lv) -> Counter:
        fn = api.rows_function(filter_name, lv, radius, c, w, taps, dev)
        return launched(lambda: fn(frame.view(h, w * c)))

    params = {"gaussian": {"sigma": SIGMA, "radius": radius},
              "box": {"radius": radius}, "sobel": {}}[filter_name]
    module = get_filter(filter_name, level=level, **params).to(dev)
    rt = FilterRuntime(dev)
    assert launched(lambda: rt.launch_once(filter_name, img, level, SIGMA,
                                           radius)) == routed(level)
    assert launched(lambda: module(frame)) == routed(1 if level == 1 else 2)
    batch = make_batch_filter(make_mesh(1, dp=1, sp=1, devices=[dev]),
                              filter_name, radius=radius, level=level)
    batch_level = level if filter_name == "sobel" else min(level, 2)
    assert launched(lambda: batch(frame[None], *([taps] if taps is not None
                                                 else []))) == routed(batch_level)
    assert launched(lambda: api.filtered(frame, filter_name, level, radius,
                                         taps)) == routed(level)
