"""The kernel wrappers' launch plans (`ops/cuda/plan.py`).

On the CPU, a stub stands in for the ctypes library: a plan is built once
per (launch function, radius, channels, card) and serves images of every
size and batch; a changed gaussian table makes a new tap array with the
new values; bad rows, tables and caps raise as they did before plans;
`LAUNCH_PLANS` counts plans built and held and tap arrays rebuilt; a
launch under `counted_apart` counts apart and each `count_replay` adds it.
On the card (`cuda`): every blur and Sobel route through its plan equals
its plain version byte for byte, single images and batches; a launch
captured in a CUDA graph and replayed equals the eager launch; threads
with different tables on one plan keep their own taps.  The file imports
neither JAX nor the JAX package, so it runs on the card's machine with
`python -m pytest --noconftest tests/test_torch_launch_plan.py -m cuda`.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu_torch.ops.cuda import (
    LAUNCH_PLANS,
    LAUNCHES,
    ROUTES,
    blur,
    blur_planar,
    count_replay,
    counted_apart,
    plan,
    sobel,
    sobel_planar,
)
from gpu_image_processing_tpu_torch.ops.weights import (
    bf16_split,
    gaussian_kernel_f32,
    weights_to_torch,
)

CPU = torch.device("cpu")
STREAM = 0x5EED


class StubLibrary:
    """blur.cu's and sobel.cu's launch functions, recorded: each call's
    arguments, a tap array as its values."""

    def __init__(self, code: int = 0):
        self.code = code
        self.calls: list[tuple[str, tuple]] = []

    def __getattr__(self, fn_name: str):
        if not fn_name.startswith("gip_"):
            raise AttributeError(fn_name)

        def launch(*args):
            self.calls.append((fn_name, tuple(
                list(a) if hasattr(a, "_length_") else a for a in args)))
            return self.code

        return launch

    @staticmethod
    def gip_blur_route(kind: int, radius: int, channels: int) -> int:
        """blur.cu's rules, as far as these tests reach them."""
        if kind == blur.BOX:
            return (3 << 8 | radius if radius <= 7
                    else 4 << 8 if radius <= 64 else 5 << 8)
        return (1 + kind) << 8 | (radius if radius <= 15 else 0)

    @staticmethod
    def gip_error_string(code: int) -> bytes:
        return b"stub error"


@pytest.fixture
def stub(monkeypatch):
    """A fresh set of plans, whose libraries are one `StubLibrary`; counts
    the libraries the plans loaded in `stub.loads`."""
    lib = StubLibrary()
    lib.loads = []

    def library(device):
        lib.loads.append(device)
        return lib

    monkeypatch.setattr(plan, "_PLANS", {})
    monkeypatch.setattr(blur, "_ROUTES", {})
    monkeypatch.setattr(blur, "library", library)
    monkeypatch.setattr(sobel, "library", library)
    monkeypatch.setattr(plan, "_current_device", lambda: -1)
    monkeypatch.setattr(plan, "_current_stream", lambda device: STREAM)
    launches, routes = LAUNCHES.copy(), ROUTES.copy()
    yield lib
    LAUNCHES.subtract(LAUNCHES - launches)
    ROUTES.subtract(ROUTES - routes)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _rows(shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.uint8)


def _table(radius: int, sigma: float) -> torch.Tensor:
    return weights_to_torch(gaussian_kernel_f32(radius, sigma), CPU)


def _counts() -> dict:
    return dict(LAUNCH_PLANS)


def _delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in LAUNCH_PLANS.items()
            if v != before.get(k, 0)}


# -- on the CPU, a stub for the library -------------------------------------


def test_a_plan_is_built_once_per_function_radius_and_channels(stub):
    w = _table(3, 2.0)
    before = _counts()
    # Sizes and batches of one key share its plan.
    for shape in [(4, 12), (9, 30), (2, 5, 12), (7, 3, 21)]:
        blur._launch_gaussian("gip_gaussian_rows", _rows(shape), w, 3, 3)
    assert len(stub.loads) == 1 and len(plan._PLANS) == 1
    assert _delta(before) == {"built": 1, "held": 3}
    # Another radius, channel count or function is another plan.
    blur._launch_gaussian("gip_gaussian_rows", _rows((4, 12)), w[1:-1], 2, 3)
    blur._launch_gaussian("gip_gaussian_rows", _rows((4, 12)), w, 3, 1)
    blur._launch_gaussian("gip_gaussian_folded_rows", _rows((4, 12)), w, 3, 3)
    sobel._launch("gip_sobel_rows", _rows((4, 12)), 4, 3)
    sobel._launch("gip_sobel_rows", _rows((3, 4, 12)), 4, 3)
    assert len(plan._PLANS) == 5 and len(stub.loads) == 5
    assert _delta(before) == {"built": 5, "held": 4}
    assert set(plan._PLANS) == {
        ("gip_gaussian_rows", 3, 3, -1), ("gip_gaussian_rows", 2, 3, -1),
        ("gip_gaussian_rows", 3, 1, -1), ("gip_gaussian_folded_rows", 3, 3, -1),
        ("gip_sobel_rows", 0, 3, -1)}


def test_a_launch_passes_its_shape_and_the_current_stream(stub):
    w = _table(3, 2.0)
    blur._launch_gaussian("gip_gaussian_rows", _rows((2, 5, 12)), w, 3, 3)
    blur._launch("gip_box_wide_rows", _rows((6, 8)), 2, 70, 0.5, scratch=True)
    sobel_planar._launch("gip_sobel_planar", _rows((3, 6, 5)), True, False)
    blur_planar._launch("gip_box_planar", _rows((4, 6, 5)), (4, 6, 5), 2,
                        False, 0.25)
    (g, g_args), (b, b_args), (s, s_args), (p, p_args) = stub.calls
    assert g == "gip_gaussian_rows"
    # input, output, taps, radius, batch, height, width, channels, stream
    assert g_args[2] == w.tolist() and g_args[3:] == (3, 2, 5, 4, 3, STREAM)
    # input, scratch, output, scale, radius, batch, height, width, channels
    assert b == "gip_box_wide_rows" and len(set(b_args[:3])) == 3
    assert b_args[3:] == (0.5, 70, 1, 6, 4, 2, STREAM)
    # planes, output, batch, channels, height, width, prepadded, zero rows
    assert s == "gip_sobel_planar" and s_args[2:] == (1, 3, 4, 5, 1, 0, STREAM)
    assert p == "gip_box_planar" and p_args[2:] == (0.25, 2, 4, 6, 5, 0, STREAM)


def test_a_changed_table_rebuilds_the_tap_array(stub):
    rows = _rows((4, 12))
    one, two = _table(3, 1.0), _table(3, 2.0)
    before = _counts()
    for w in (one, one, two, two, one):
        blur._launch_gaussian("gip_gaussian_rows", rows, w, 3, 3)
    assert [args[2] for _, args in stub.calls] == [
        one.tolist(), one.tolist(), two.tolist(), two.tolist(), one.tolist()]
    assert _delta(before) == {"built": 1, "held": 4, "taps_rebuilt": 2}
    # A table changed in place between two calls is honoured.
    one[3] = 0.5
    blur._launch_gaussian("gip_gaussian_rows", rows, one, 3, 3)
    assert stub.calls[-1][1][2] == one.tolist() and one.tolist()[3] == 0.5
    assert _delta(before)["taps_rebuilt"] == 3
    # The planar blur's taps go the same way.
    blur_planar._launch("gip_gaussian_planar", _rows((3, 4, 4)), (3, 4, 4), 3,
                        False, two)
    assert stub.calls[-1][1][2] == two.tolist()


def test_each_launch_keeps_the_array_it_was_given(stub):
    # A launch reads its taps from the array it was handed, never from the
    # plan's slot that a later table replaces.
    p = blur.plan_for("gip_gaussian_rows", _rows((4, 12)), 3, 3)
    one, two = _table(3, 1.0), _table(3, 2.0)
    first = p.host_taps(one)
    second = p.host_taps(two)
    assert list(first) == one.tolist() and list(second) == two.tolist()
    assert p.host_taps(two) is second


@pytest.mark.parametrize("launch,message", [
    (lambda r: blur.box_rows(r.to(torch.int16), 2, 3),
     r"contiguous \(H, W\*C\) or \(B, H, W\*C\) uint8 rows; got torch.int16"),
    (lambda r: blur.box_rows(r[:, ::2], 2, 3), r"got torch.uint8 \(4, 6\)"),
    (lambda r: blur.box_rows(r[None, None], 2, 3),
     r"uint8 rows; got torch.uint8 \(1, 1, 4, 12\)"),
    (lambda r: blur.box_rows(r, 2, 5), "row width 12 is not a multiple of 5"),
    (lambda r: blur.box_rows(r, 0, 3), "radius must be >= 1; got 0"),
    (lambda r: blur.box_rows(r, 2, 17),
     "box_rows takes at most 16 channels on the card; got 17"),
    (lambda r: blur.gaussian_rows(r, torch.zeros(5), 3, 3),
     r"weights must be a contiguous \(7,\) float32 tensor on meta or the "
     r"host"),
    (lambda r: blur.gaussian_rows(r, torch.zeros(7, dtype=torch.float64), 3,
                                  3), r"\(7,\) float32 tensor"),
    (lambda r: blur.gaussian_rows(r, torch.zeros(65), 32, 3),
     "gaussian kernel takes r <= 31 and at most 32 channels; got r = 32"),
    (lambda r: blur.gaussian_band_rows(r, torch.zeros(7, device="meta"),
                                       torch.zeros(7), 3, 3),
     r"lo must be a contiguous \(7,\) float32 tensor on meta$"),
    (lambda r: blur.gaussian_band_rows(
        r, *(torch.zeros(65, device="meta"),) * 2, 32, 3),
     "band kernel takes r <= 31 and at most 4 channels; got r = 32"),
    (lambda r: sobel.sobel_rows(r, 5, 2), r"C in \(1, 3, 4\); got 6 of C=2"),
    (lambda r: sobel.sobel_rows(r, 3, 3), "expected 3 pixels"),
    (lambda r: sobel_planar.sobel_planar(r.view(3, 4, 4)[:2]),
     r"channels must be one of \(1, 3, 4\); got 2"),
    (lambda r: blur_planar.gaussian_planar(r.view(3, 4, 4), torch.zeros(41),
                                           20, rows_prepadded=True),
     r"planes of 4 rows x 4 hold no output at r = 20 with halo rows"),
])
def test_bad_rows_tables_and_caps_raise_as_before(stub, launch, message):
    # On meta tensors: the checks run before any plan is asked for.
    before = _counts()
    rows = torch.zeros((4, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match=message):
        launch(rows)
    assert stub.loads == [] and plan._PLANS == {} and _delta(before) == {}


def test_a_failed_launch_raises_its_error_and_counts_nothing(stub):
    stub.code = 700
    launches = LAUNCHES.copy()
    with pytest.raises(RuntimeError,
                       match="gip_sobel_rows: CUDA error 700: stub error"):
        sobel._launch("gip_sobel_rows", _rows((4, 12)), 4, 3)
    assert LAUNCHES == launches


def test_a_plan_that_cannot_load_is_not_kept(monkeypatch):
    # The loader refuses anything but an sm_90 card; nothing is kept, so
    # every launch on such a tensor raises again.
    monkeypatch.setattr(plan, "_PLANS", {})
    rows = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cuda device"):
            blur.box_rows(rows, 2, 3)
    assert plan._PLANS == {}


def test_launches_count_by_name_and_route(stub):
    launches, routes = LAUNCHES.copy(), ROUTES.copy()
    blur._launch("gip_box_window_rows", _rows((4, 12)), 3, 5, 0.1)
    blur._launch("gip_box_window_rows", _rows((4, 12)), 3, 5, 0.1)
    blur_planar._launch("gip_box_planar", _rows((3, 4, 4)), (3, 4, 4), 20,
                        False, 0.1)
    sobel._launch("gip_sobel_f32_rows", _rows((4, 12)), 4, 3)
    assert LAUNCHES - launches == {"box_rows": 2, "box_planar": 1,
                                   "sobel_f32_rows": 1}
    assert ROUTES - routes == {"box_rows: gauss_window_rows<Box, 5>": 2,
                               "box_planar: box_window_rows": 1}


def test_launches_under_capture_count_apart_and_replays_add_them(stub):
    launches, routes = LAUNCHES.copy(), ROUTES.copy()
    before = _counts()
    w = _table(3, 2.0)
    with counted_apart() as mine:
        blur._launch_gaussian("gip_gaussian_rows", _rows((4, 12)), w, 3, 3)
        sobel._launch("gip_sobel_rows", _rows((4, 12)), 4, 3)
    assert LAUNCHES == launches and ROUTES == routes
    assert mine == {"gaussian_rows": 1, "sobel_rows": 1}
    assert mine.routes == {"gaussian_rows: gauss_window_rows<Weighted, 3>": 1}
    # The plans count the host work the capture did, once.
    assert _delta(before) == {"built": 2}
    count_replay(mine)
    count_replay(mine)
    assert LAUNCHES - launches == {"gaussian_rows": 2, "sobel_rows": 2}
    assert ROUTES - routes == {
        "gaussian_rows: gauss_window_rows<Weighted, 3>": 2}
    assert _delta(before) == {"built": 2}


def test_threads_launching_a_new_key_build_its_plan_once(stub, monkeypatch):
    # Many threads, one key, switches forced often: one plan, one load.
    monkeypatch.setattr(plan, "_PLANS", {})
    before = _counts()
    start = threading.Barrier(16)
    rows = _rows((4, 12))

    def worker():
        start.wait(timeout=30)
        for _ in range(50):
            blur._launch("gip_box_window_rows", rows, 3, 5, 0.1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(stub.loads) == 1 and len(plan._PLANS) == 1
    assert len(stub.calls) == 16 * 50
    assert _delta(before)["built"] == 1


def test_the_server_shows_the_launch_plans(stub):
    from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
    from gpu_image_processing_tpu_torch.server.app import create_app
    from gpu_image_processing_tpu_torch.server.http import Request

    sobel._launch("gip_sobel_rows", _rows((4, 12)), 4, 3)
    sobel._launch("gip_sobel_rows", _rows((4, 12)), 4, 3)
    status, stats = create_app(FilterRuntime("cpu")).dispatch(
        Request(method="GET", path="/api/stats"))
    assert status == 200 and stats["launch_plans"] == dict(LAUNCH_PLANS)
    assert stats["launch_plans"]["built"] >= 1
    assert stats["launch_plans"]["held"] >= 1


# -- on the card ------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


def _image(rng, *shape) -> np.ndarray:
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _host(radius: int, sigma: float) -> torch.Tensor:
    return _table(radius, sigma)


# (name, launch of (rows, channels), plain of (rows, channels), route)
ROUTED = [
    ("weighted3", lambda x, c: blur.gaussian_rows(x, _host(3, 2.0), 3, c),
     lambda x, c: blur.gaussian_rows_plain(x, _host(3, 2.0), 3, c),
     "gaussian_rows: gauss_window_rows<Weighted, 3>"),
    ("weighted15", lambda x, c: blur.gaussian_rows(x, _host(15, 20.0), 15, c),
     lambda x, c: blur.gaussian_rows_plain(x, _host(15, 20.0), 15, c),
     "gaussian_rows: gauss_window_rows<Weighted, 15>"),
    ("weighted0", lambda x, c: blur.gaussian_rows(x, _host(20, 8.0), 20, c),
     lambda x, c: blur.gaussian_rows_plain(x, _host(20, 8.0), 20, c),
     "gaussian_rows: gauss_window_rows<Weighted, 0>"),
    ("folded2", lambda x, c: blur.gaussian_folded_rows(x, _host(2, 1.5), 2, c),
     lambda x, c: blur.gaussian_folded_rows_plain(x, _host(2, 1.5), 2, c),
     "gaussian_folded_rows: gauss_window_rows<Folded, 2>"),
    ("box5", lambda x, c: blur.box_rows(x, 5, c),
     lambda x, c: blur.box_rows_plain(x, 5, c),
     "box_rows: gauss_window_rows<Box, 5>"),
    ("box15", lambda x, c: blur.box_rows(x, 15, c),
     lambda x, c: blur.box_rows_plain(x, 15, c), "box_rows: box_window_rows"),
    ("box_wide", lambda x, c: blur.box_rows(x, 70, c),
     lambda x, c: blur.box_rows_plain(x, 70, c),
     "box_rows: box_wide_h + box_wide_v"),
    ("sobel", lambda x, c: sobel.sobel_rows(x, x.shape[-1] // c, c),
     lambda x, c: sobel.sobel_rows_plain(x, x.shape[-1] // c, c), None),
    ("sobel_f32", lambda x, c: sobel.sobel_f32_rows(x, x.shape[-1] // c, c),
     lambda x, c: sobel.sobel_f32_rows_plain(x, x.shape[-1] // c, c), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,launch,plain,route", ROUTED,
                         ids=[r[0] for r in ROUTED])
def test_every_route_through_its_plan_equals_plain(rng, name, launch, plain,
                                                   route):
    dev = _card()
    before = _counts()
    routes = ROUTES.copy()
    calls = 0
    for h, w, c in [(37, 301, 3), (64, 96, 3), (20, 70, 1), (33, 150, 4)]:
        if name.startswith("sobel") and c not in (1, 3, 4):
            continue
        rows = torch.from_numpy(_image(rng, h, w * c)).to(dev)
        batch = torch.from_numpy(_image(rng, 3, h, w * c)).to(dev)
        assert torch.equal(launch(rows, c), plain(rows, c)), (h, w, c)
        out = launch(batch, c)
        assert torch.equal(out, plain(batch, c)), (h, w, c)
        for i in range(3):
            assert torch.equal(out[i], launch(batch[i].contiguous(), c))
        calls += 5
    torch.cuda.synchronize()
    got = _delta(before)
    # A plan per channel count (3 of them), every other launch held.
    assert got.get("built", 0) <= 3
    assert got.get("built", 0) + got.get("held", 0) == calls
    if route is not None:
        assert (ROUTES - routes)[route] == calls


@pytest.mark.cuda
def test_the_band_through_its_plan_equals_its_single_launches(rng):
    dev = _card()
    table = gaussian_kernel_f32(15, 5.0)
    hi, lo = (torch.from_numpy(t).to(dev) for t in bf16_split(table))
    batch = torch.from_numpy(_image(rng, 3, 40, 96 * 3)).to(dev)
    out = blur.gaussian_band_rows(batch, hi, lo, 15, 3)
    plain = blur.gaussian_band_rows_plain(batch, hi, lo, 15, 3)
    diff = (out.int() - plain.int()).abs()
    assert diff.max() <= blur.BAND_MAX_DIFF
    assert (diff > 0).float().mean() <= blur.BAND_MAX_FRACTION
    for i in range(3):
        assert torch.equal(out[i], blur.gaussian_band_rows(
            batch[i].contiguous(), hi, lo, 15, 3))


@pytest.mark.cuda
def test_the_planar_tier_through_its_plans_equals_plain(rng):
    dev = _card()
    planes = torch.from_numpy(_image(rng, 6, 40, 57)).to(dev)
    w = _host(3, 2.0)
    assert torch.equal(blur_planar.gaussian_planar(planes, w, 3),
                       blur_planar.gaussian_planar_plain(planes, w, 3))
    assert torch.equal(blur_planar.box_planar(planes, 15),
                       blur_planar.box_planar_plain(planes, 15))
    img = planes.view(2, 3, 40, 57)
    assert torch.equal(sobel_planar.sobel_planar(img),
                       sobel_planar.sobel_planar_plain(img, 2))


@pytest.mark.cuda
def test_a_captured_launch_replays_as_the_eager_launch(rng):
    # The capture runs on a stream of its own: the plan reads the current
    # stream on every launch, so the capture records the kernel and each
    # replay runs it on the input's current bytes.
    dev = _card()
    w = _host(3, 2.0)
    rows = torch.from_numpy(_image(rng, 64, 300 * 3)).to(dev)
    fns = [lambda x: blur.gaussian_rows(x, w, 3, 3),
           lambda x: blur.box_rows(x, 15, 3),
           lambda x: sobel.sobel_rows(x, 300, 3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn(rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with counted_apart() as mine, torch.cuda.graph(graph):
        outs = [fn(rows) for fn in fns]
    assert mine == {"gaussian_rows": 1, "box_rows": 1, "sobel_rows": 1}
    for _ in range(2):
        rows.copy_(torch.from_numpy(_image(rng, 64, 300 * 3)).to(dev))
        graph.replay()
        torch.cuda.synchronize()
        for fn, out in zip(fns, outs):
            assert torch.equal(out, fn(rows))


@pytest.mark.cuda
def test_threads_with_other_tables_on_one_plan_keep_their_taps(rng):
    # r = 3 at sigma 1 and 2 share one plan: each launch passes its own
    # taps, so the plan's tap array is rebuilt as the threads alternate.
    dev = _card()
    rows = torch.from_numpy(_image(rng, 64, 300 * 3)).to(dev)
    sigmas = (1.0, 2.0)
    outs = {s: [] for s in sigmas}
    before = _counts()

    def worker(sigma):
        w = _host(3, sigma)
        for _ in range(200):
            outs[sigma].append(blur.gaussian_rows(rows, w, 3, 3))

    threads = [threading.Thread(target=worker, args=(s,)) for s in sigmas]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for sigma, got in outs.items():
        want = blur.gaussian_rows_plain(rows, _host(3, sigma), 3, 3)
        assert len(got) == 200 and all(torch.equal(g, want) for g in got)
    assert _delta(before).get("built", 0) <= 1


@pytest.mark.cuda
def test_a_forward_frame_is_served_by_held_plans(rng):
    from gpu_image_processing_tpu_torch.models import (
        BoxBlur,
        GaussianBlur,
        SobelEdgeDetection,
    )

    dev = _card()
    frame = torch.from_numpy(_image(rng, 64, 96, 3)).to(dev)
    models = [GaussianBlur(2.0, 3), BoxBlur(5), SobelEdgeDetection()]
    for m in models:
        m(frame)
    before = _counts()
    for _ in range(1000):
        for m in models:
            m(frame)
    torch.cuda.synchronize()
    assert _delta(before) == {"held": 3000}
