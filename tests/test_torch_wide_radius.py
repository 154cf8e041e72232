"""The strongest blur the upstream UI offers (both sliders at their far
end: gaussian sigma 20, r 15; box r 15) on the port, and the route record
that names the device function each blur launch ran.

On the CPU: the modules' `forward` and the API at levels 1, 2 and 4
against the benchmark's plain reference (`portbench/reference/filters.py`)
and the numpy oracle, byte for byte (the level-4 gaussian within the
band's stated tolerance); the plain versions at the radii where the card's
route changes; the benchmark cell that runs this deployment and its
readers; the launch and route counters.  On the card (`cuda`): the route
each radius takes, and a graph's replay counting its routes.  The file
imports neither JAX nor the JAX package, so it runs on the card's machine
with `python -m pytest --noconftest tests/test_torch_wide_radius.py -m
cuda`.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu_torch.api import filters as api
from gpu_image_processing_tpu_torch.models import BoxBlur, GaussianBlur
from gpu_image_processing_tpu_torch.ops.cuda import (
    LAUNCHES,
    ROUTES,
    blur,
    blur_planar,
    count_launch,
    count_replay,
    counted_apart,
)
from gpu_image_processing_tpu_torch.ops.weights import (
    bf16_split,
    gaussian_kernel_f32,
    weights_to_torch,
)
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from portbench.harness import schedule, spec
from portbench.harness.trace import Trace
from portbench.reference import filters as reference
from portbench.reference.work import least_seconds

from . import oracle_numpy as oracle

SIGMA, RADIUS = 20.0, 15
CELL = "lib_photo_r15.forward_frames"
# Seeded images of 1, 3 and 4 channels; the second is narrower and shorter
# than the radius, so every tap of it clamps at an edge.
SHAPES = [(40, 37, 3), (9, 11, 3), (21, 26, 4), (33, 18, 1)]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def make_image(rng, h, w, c):
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)


def _t(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img))


def _want(name: str, img: np.ndarray) -> np.ndarray:
    """The plain reference's answer, after checking it against the oracle."""
    if name == "gaussian":
        want = reference.gaussian(_t(img), SIGMA, RADIUS).numpy()
        table = gaussian_kernel_f32(RADIUS, SIGMA)
        np.testing.assert_array_equal(
            table, reference.gaussian_table(RADIUS, SIGMA))
        np.testing.assert_array_equal(
            want, oracle.gaussian_blur(img, table, RADIUS))
    else:
        want = reference.box(_t(img), RADIUS).numpy()
        np.testing.assert_array_equal(want, oracle.box_blur(img, RADIUS))
    return want


def _assert_band_close(got: np.ndarray, want: np.ndarray,
                       share: bool = True) -> None:
    """Level 4's contract: within `BAND_MAX_DIFF` of the level-1 function,
    on at most `BAND_MAX_FRACTION` of the bytes where `share` (an image of
    a few thousand bytes has a few bytes on a .5 tie, a share of 0.2%)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert int(diff.max()) <= blur.BAND_MAX_DIFF
    if share:
        assert float((diff > 0).mean()) <= blur.BAND_MAX_FRACTION


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2, 4])
@pytest.mark.parametrize("name", ["gaussian", "box"])
def test_forward_at_the_sliders_far_end_is_the_reference(rng, shape, level,
                                                         name):
    img = make_image(rng, *shape)
    module = (GaussianBlur(sigma=SIGMA, radius=RADIUS, level=level)
              if name == "gaussian" else BoxBlur(radius=RADIUS, level=level))
    # A module's level 4 is the level-2 function: exact at every level.
    np.testing.assert_array_equal(module(_t(img)).numpy(), _want(name, img))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2, 4])
@pytest.mark.parametrize("name", ["gaussian", "box"])
def test_api_at_the_sliders_far_end_is_the_reference(rng, shape, level, name):
    img = make_image(rng, *shape)
    rt = FilterRuntime("cpu")
    if name == "gaussian":
        got = api.gaussian_blur(img, sigma=SIGMA, radius=RADIUS, level=level,
                                runtime=rt)["image"]
    else:
        got = api.box_blur(img, radius=RADIUS, level=level,
                           runtime=rt)["image"]
    want = _want(name, img)
    if name == "gaussian" and level == 4:
        _assert_band_close(got, want, share=False)   # the bf16 band
    else:
        np.testing.assert_array_equal(got, want)


def test_api_level4_gaussian_on_a_larger_image_stays_within_the_band(rng):
    # Enough bytes that the band's 0.1% admits a few and not many (5 of
    # 15,360 on this seed).
    img = make_image(rng, 64, 80, 3)
    got = api.gaussian_blur(img, sigma=SIGMA, radius=RADIUS, level=4,
                            runtime=FilterRuntime("cpu"))["image"]
    _assert_band_close(got, _want("gaussian", img))


def _rows(img: np.ndarray) -> torch.Tensor:
    h, w, c = img.shape
    return _t(img.reshape(h, w * c))


# Where the card's route changes: box window taps to r = 7, running sums
# from 8 to 64, two wide launches past 64; the gaussian's own kernels to
# r = 15, the run-time radius from 16, r = 31's own kernel.
@pytest.mark.parametrize("radius", [7, 8, 64, 65])
@pytest.mark.parametrize("shape", [(30, 41, 3), (9, 11, 1)])
def test_box_plain_at_the_route_boundaries(rng, radius, shape):
    img = make_image(rng, *shape)
    got = blur.box_rows_plain(_rows(img), radius, shape[2]).numpy()
    np.testing.assert_array_equal(got.reshape(shape),
                                  oracle.box_blur(img, radius))
    planes = _t(np.moveaxis(img, 2, 0).copy())
    if radius <= 31:   # the planar blur takes 2r + 1 <= 63 taps
        got = blur_planar.box_planar(planes, radius).numpy()
        np.testing.assert_array_equal(np.moveaxis(got, 0, 2),
                                      oracle.box_blur(img, radius))


@pytest.mark.parametrize("radius", [15, 16, 31])
@pytest.mark.parametrize("shape", [(30, 41, 3), (9, 11, 4)])
def test_gaussian_plain_at_the_route_boundaries(rng, radius, shape):
    img = make_image(rng, *shape)
    table = gaussian_kernel_f32(radius, SIGMA)
    w = weights_to_torch(table, torch.device("cpu"))
    got = blur.gaussian_rows_plain(_rows(img), w, radius, shape[2]).numpy()
    np.testing.assert_array_equal(got.reshape(shape),
                                  oracle.gaussian_blur(img, table, radius))


# -- the benchmark's cell -------------------------------------------------


def test_the_cell_loads_with_its_two_r15_calls():
    cell = spec.load(CELL)
    assert cell.chips == 1 and cell.mix["entry"] == "forward"
    assert cell.config["reduced"] == []
    work = schedule.distinct_work(cell.mix, cell.config)
    assert [(c.filter, c.level, c.sigma, c.radius, c.size) for c in work] == [
        ("gaussian", 2, SIGMA, RADIUS, (2146, 3239)),
        ("box", 2, 0.0, RADIUS, (2146, 3239))]
    assert [m["name"] for m, _ in cell.end_to_end] == ["frames_per_s",
                                                       "setup_s"]
    assert [m["name"] for m, _ in cell.per_layer] == [
        "device.idle_pct.forward_r15", "kernels_roofline.r15"]


def test_the_yardstick_of_the_r15_calls():
    shape = (2146, 3239, 3)
    # The gaussian's 31 taps a pass make it bound by its operations, the
    # first such function of any cell; the box stays bound by its bytes.
    assert least_seconds("gaussian", 2, shape, RADIUS) * 1e6 == \
        pytest.approx(38.59, abs=0.005)
    assert least_seconds("box", 2, shape, RADIUS) * 1e6 == \
        pytest.approx(12.45, abs=0.005)


def test_the_cells_readers_read_the_trace_and_nothing_without_it():
    readers = {m["name"]: r for m, r in spec.load(CELL).per_layer}
    roofline = spec.load_reader("metrics", "kernels_roofline").read
    work = [("gaussian", 2, (2146, 3239, 3), RADIUS),
            ("box", 2, (2146, 3239, 3), RADIUS)] * 50
    obs = {"trace": Trace(window_s=1.0, busy_s=0.01), "work": work}
    need = 50 * (38.597 + 12.450) * 1e-6
    assert readers["kernels_roofline.r15"].read(obs) == pytest.approx(
        100.0 * need / 0.01, rel=1e-4)
    assert readers["kernels_roofline.r15"].read(obs) == roofline(obs)
    assert readers["device.idle_pct.forward_r15"].read(obs) == \
        pytest.approx(99.0)
    for reader in readers.values():
        assert reader.read({"trace": None, "work": work}) is None


# -- the launch and route counters ------------------------------------------


def test_routes_are_counted_by_wrapper_and_function():
    launches, routes = LAUNCHES.copy(), ROUTES.copy()
    count_launch("box_rows", "box_window_rows")
    count_launch("sobel_rows")
    assert LAUNCHES - launches == {"box_rows": 1, "sobel_rows": 1}
    assert ROUTES - routes == {"box_rows: box_window_rows": 1}
    LAUNCHES.subtract({"box_rows": 1, "sobel_rows": 1})
    ROUTES.subtract({"box_rows: box_window_rows": 1})


def test_a_capture_counts_routes_apart_and_each_replay_counts_them():
    launches, routes = LAUNCHES.copy(), ROUTES.copy()
    inside, outside = threading.Event(), threading.Event()

    def other() -> None:
        inside.wait()
        count_launch("box_rows", "box_window_rows")   # another thread
        outside.set()

    th = threading.Thread(target=other)
    th.start()
    with counted_apart() as mine:
        count_launch("gaussian_rows", "gauss_window_rows<Weighted, 15>")
        inside.set()
        outside.wait()
    th.join()
    assert mine == {"gaussian_rows": 1}
    assert mine.routes == {"gaussian_rows: gauss_window_rows<Weighted, 15>": 1}
    assert ROUTES - routes == {"box_rows: box_window_rows": 1}
    count_replay(mine)
    count_replay(mine)
    assert LAUNCHES - launches == {"box_rows": 1, "gaussian_rows": 2}
    assert ROUTES - routes == {
        "box_rows: box_window_rows": 1,
        "gaussian_rows: gauss_window_rows<Weighted, 15>": 2}
    LAUNCHES.subtract(LAUNCHES - launches)
    ROUTES.subtract(ROUTES - routes)


def test_route_names_what_blur_cu_answers():
    # Every launch function is counted under its wrapper's name and kind.
    assert set(blur._COUNTED) == set(blur._SIGNATURES) - {"gip_blur_route"}
    # The library's answer, (function << 8) | template radius, named.
    answers = {(blur.WEIGHTED, 15, 3): 1 << 8 | 15,
               (blur.WEIGHTED, 16, 3): 1 << 8 | 0,
               (blur.FOLDED, 2, 3): 2 << 8 | 2,
               (blur.BOX, 7, 3): 3 << 8 | 7,
               (blur.BOX, 15, 3): 4 << 8,
               (blur.BOX, 65, 3): 5 << 8,
               (blur.BAND, 15, 3): 6 << 8,
               (blur.BOX, 0, 3): -1}
    lib = SimpleNamespace(gip_blur_route=lambda *key: answers[key])
    blur._ROUTES.clear()
    try:
        assert [blur.route(lib, *key) for key in list(answers)[:-1]] == [
            "gauss_window_rows<Weighted, 15>",
            "gauss_window_rows<Weighted, 0>",
            "gauss_window_rows<Folded, 2>", "gauss_window_rows<Box, 7>",
            "box_window_rows", "box_wide_h + box_wide_v", "band_mma_rows"]
        with pytest.raises(ValueError, match="r = 0"):
            blur.route(lib, blur.BOX, 0, 3)
    finally:
        blur._ROUTES.clear()


# -- on the card ----------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda")


def _routed(launch) -> dict:
    before = ROUTES.copy()
    launch()
    torch.cuda.synchronize()
    return dict(ROUTES - before)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,gaussian,box", [
    (3, "gauss_window_rows<Weighted, 3>", "gauss_window_rows<Box, 3>"),
    (7, "gauss_window_rows<Weighted, 7>", "gauss_window_rows<Box, 7>"),
    (8, "gauss_window_rows<Weighted, 8>", "box_window_rows"),
    (15, "gauss_window_rows<Weighted, 15>", "box_window_rows"),
    (16, "gauss_window_rows<Weighted, 0>", "box_window_rows"),
    (31, "gauss_window_rows<Weighted, 31>", "box_window_rows"),
    (65, None, "box_wide_h + box_wide_v")])
def test_kernel_routes_name_the_function_each_radius_runs(rng, radius,
                                                          gaussian, box):
    dev = _card()
    img = make_image(rng, 45, 70, 3)
    rows = _rows(img).to(dev)
    assert _routed(lambda: blur.box_rows(rows, radius, 3)) == {
        f"box_rows: {box}": 1}
    np.testing.assert_array_equal(
        blur.box_rows(rows, radius, 3).cpu().numpy().reshape(img.shape),
        oracle.box_blur(img, radius))
    if gaussian is None:
        return
    table = gaussian_kernel_f32(radius, SIGMA)
    w = weights_to_torch(table, torch.device("cpu"))
    assert _routed(lambda: blur.gaussian_rows(rows, w, radius, 3)) == {
        f"gaussian_rows: {gaussian}": 1}
    planes = _t(np.moveaxis(img, 2, 0).copy()).to(dev)
    assert _routed(lambda: blur_planar.gaussian_planar(planes, w, radius)) == {
        f"gaussian_planar: {gaussian}": 1}
    assert _routed(lambda: blur_planar.box_planar(planes, radius)) == {
        f"box_planar: {box}": 1}
    hi, lo = (weights_to_torch(t, dev) for t in bf16_split(table))
    assert _routed(lambda: blur.gaussian_band_rows(rows, hi, lo, radius, 3)) \
        == {"gaussian_band_rows: band_mma_rows": 1}
    folded = "gauss_window_rows<Folded, 0>"
    assert _routed(lambda: blur.gaussian_folded_rows(rows, w, radius, 3)) \
        == {f"gaussian_folded_rows: {folded}": 1}


@pytest.mark.cuda
def test_the_cells_modules_route_and_the_server_shows_it(rng):
    from gpu_image_processing_tpu_torch.server.app import create_app
    from gpu_image_processing_tpu_torch.server.http import Request

    dev = _card()
    frame = _t(make_image(rng, 64, 96, 3)).to(dev)
    got = _routed(lambda: (GaussianBlur(SIGMA, RADIUS)(frame),
                           BoxBlur(RADIUS)(frame)))
    assert got == {"gaussian_rows: gauss_window_rows<Weighted, 15>": 1,
                   "box_rows: box_window_rows": 1}
    status, stats = create_app(FilterRuntime(dev)).dispatch(
        Request(method="GET", path="/api/stats"))
    assert status == 200 and stats["kernel_routes"] == dict(ROUTES)


@pytest.mark.cuda
def test_a_graph_replay_counts_its_routes(rng):
    dev = _card()
    img = make_image(rng, 61, 97, 3)
    rt = FilterRuntime(dev)
    for _ in range(2):   # the second request captures the graph
        rt.run("gaussian", img, level=2, sigma=SIGMA, radius=16)
    (exe,) = rt.executables.values()
    assert exe.captured
    assert exe.launches.routes == {
        "gaussian_rows: gauss_window_rows<Weighted, 0>": 1}
    launches, routes = LAUNCHES.copy(), ROUTES.copy()
    with exe.staged(img.reshape(61, -1)):
        replayed = exe.fetch(exe.run()).reshape(img.shape)
    assert LAUNCHES - launches == exe.launches
    assert ROUTES - routes == exe.launches.routes
    table = gaussian_kernel_f32(16, SIGMA)
    np.testing.assert_array_equal(replayed,
                                  oracle.gaussian_blur(img, table, 16))
