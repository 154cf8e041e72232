"""The port's REST server against the JAX package's, request for request.

`create_app(FilterRuntime("cpu"))` of the port and the JAX `create_app()`
answer the same requests through `Router.dispatch`: the status codes, the
JSON keys and the decoded pixels must agree.  Pixel tolerances are those of
the filters (tests/test_torch_api.py): gaussian and box exact at levels 1
and 2, the level-4 gaussian within 1, Sobel `assert_sobel_close`.
"""

import base64
import io
import json
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gpu_image_processing_tpu.server.app import create_app as jax_create_app
from gpu_image_processing_tpu.server.http import Request as JaxRequest
from gpu_image_processing_tpu_torch.ops.cuda import LAUNCHES
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.server.app import (
    create_app,
    start_runtime,
    warm_kernels,
)
from gpu_image_processing_tpu_torch.server.http import AppServer, Request
from gpu_image_processing_tpu_torch.utils.image import (
    decode_base64_image,
    encode_png,
)

from .sobel_tolerance import assert_sobel_close


@pytest.fixture(scope="module")
def apps():
    return create_app(FilterRuntime("cpu")), jax_create_app()


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _image(seed=7, shape=(16, 20, 3)):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _both(apps, method, path, json_body=None, files=None):
    port, ref = apps
    got = port.dispatch(Request(method=method, path=path, json=json_body,
                                files=files or {}))
    want = ref.dispatch(JaxRequest(method=method, path=path, json=json_body,
                                   files=files or {}))
    return got, want


def _pixels(data_url):
    return decode_base64_image(data_url)


def _assert_pixels_close(filt, level, got, want):
    got, want = _pixels(got), _pixels(want)
    if filt == "sobel":
        assert_sobel_close(got, want)
    elif level == 4:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)


def _assert_same_keys(got, want):
    assert set(got) == set(want)
    for key in ("metrics", "info", "image_info"):
        if key in got:
            assert set(got[key]) == set(want[key]), key


@pytest.mark.parametrize("filt,extra", [
    ("gaussian", {}),
    ("gaussian", {"sigma": 1.5, "radius": 2}),
    ("gaussian", {"sigma": 3.0, "radius": 5}),
    ("box", {"radius": 4}),
    ("sobel", {}),
])
@pytest.mark.parametrize("level", [1, 2, 4])
def test_process_matches_jax(apps, filt, extra, level):
    payload = {"image": _png_b64(_image()), "filter": filt, "level": level, **extra}
    (status, body), (want_status, want) = _both(apps, "POST", "/api/process", payload)
    assert status == want_status == 200
    _assert_same_keys(body, want)
    assert body["info"] == want["info"]
    _assert_pixels_close(filt, level, body["processed_image"], want["processed_image"])


@pytest.mark.parametrize("filt", ["gaussian", "box", "sobel"])
def test_process_all_matches_jax(apps, filt):
    payload = {"image": _png_b64(_image(3, (14, 17, 3))), "filter": filt,
               "radius": 4, "enable_profiling": False}
    (status, body), (want_status, want) = _both(apps, "POST", "/api/process-all",
                                                payload)
    assert status == want_status == 200
    _assert_same_keys(body, want)
    assert set(body["results"]) == set(want["results"]) == {"level_1", "level_2"}
    assert body["image_info"] == want["image_info"]
    assert body["profiling_available"] is False
    np.testing.assert_array_equal(_pixels(body["original_image"]),
                                  _pixels(want["original_image"]))
    for name, res in body["results"].items():
        _assert_same_keys(res, want["results"][name])
        assert res["info"] == want["results"][name]["info"]
        _assert_pixels_close(filt, 1, res["processed_image"],
                             want["results"][name]["processed_image"])


@pytest.mark.parametrize("filt,extra", [
    ("gaussian", {"sigma": 2.0, "radius": 3}),
    ("gaussian", {"sigma": 1.0, "radius": 2}),
    ("box", {"radius": 2}),
    ("sobel", {}),
])
@pytest.mark.parametrize("level", [1, 2, 4])
def test_process_batch_matches_jax(apps, filt, extra, level):
    images = [_png_b64(_image(seed, (12, 15, 3))) for seed in range(3)]
    payload = {"images": images, "filter": filt, "level": level, **extra}
    (status, body), (want_status, want) = _both(apps, "POST",
                                                "/api/process-batch", payload)
    assert status == want_status == 200
    _assert_same_keys(body, want)
    assert body["info"] == want["info"]
    assert body["metrics"]["batch_size"] == 3
    assert body["metrics"]["images_per_second"] == body["metrics"]["fps"]
    for i, (got, ref) in enumerate(zip(body["processed_images"],
                                       want["processed_images"])):
        _assert_pixels_close(filt, level, got, ref)
        # Each image of the batch equals its own /api/process answer.
        one = apps[0].dispatch(Request(method="POST", path="/api/process", json={
            "image": images[i], "filter": filt, "level": level, **extra}))[1]
        np.testing.assert_array_equal(_pixels(got), _pixels(one["processed_image"]))


GOOD = _png_b64(_image())


@pytest.mark.parametrize("path,payload", [
    # The error probes of the verify recipe, and the schema's edges.
    ("/api/process", {"image": _png_b64(_image(1, (8, 8, 2))), "filter": "box"}),
    ("/api/process", {"image": _png_b64(_image(1, (8, 8, 2))[..., 0]), "filter": "box"}),
    ("/api/process", {"image": GOOD, "filter": "gaussian", "level": 5}),
    ("/api/process", {"image": GOOD, "filter": "gaussian", "radius": 40}),
    ("/api/process", {"image": GOOD, "filter": "box", "radius": 40}),
    ("/api/process", {"image": "not-an-image!", "filter": "box"}),
    ("/api/process", {"image": GOOD, "filter": "median"}),
    ("/api/process", {"image": GOOD}),
    ("/api/process", {"image": GOOD, "filter": "box", "level": "two"}),
    ("/api/process", {"image": GOOD, "filter": "box", "level": "2"}),
    ("/api/process", {"image": GOOD, "filter": "box", "level": 2.5}),
    ("/api/process", {"image": 7, "filter": "box"}),
    ("/api/process", [GOOD, "box"]),
    ("/api/process", None),
    ("/api/process-all", {"image": GOOD, "filter": "median"}),
    ("/api/process-all", {"image": "###", "filter": "sobel"}),
    ("/api/process-all", {"filter": "sobel"}),
    ("/api/process-batch", {"images": [], "filter": "box"}),
    ("/api/process-batch", {"filter": "box"}),
    ("/api/process-batch", {"images": [GOOD, _png_b64(_image(2, (9, 9, 3)))],
                            "filter": "box"}),
    ("/api/process-batch", {"images": [GOOD, "###"], "filter": "box"}),
    ("/api/process-batch", {"images": [GOOD], "filter": "box", "level": 3}),
    ("/api/process-batch", {"images": [GOOD], "level": 2}),
])
def test_errors_match_jax(apps, path, payload):
    (status, body), (want_status, want) = _both(apps, "POST", path, payload)
    assert status == want_status, (body, want)
    assert set(body) == set(want)
    if status in (400, 503) and "Invalid" in want["detail"]:
        assert body["detail"] == want["detail"]


@pytest.mark.parametrize("method,path", [
    ("GET", "/api/nope"), ("GET", "/api/process"), ("POST", "/api/health"),
])
def test_routing_errors_match_jax(apps, method, path):
    (status, body), (want_status, want) = _both(apps, method, path)
    assert (status, body) == (want_status, want)


@pytest.mark.parametrize("arr", [_image(5), _image(5, (6, 9, 1))[..., 0],
                                 _image(5, (6, 9, 4))])
def test_upload_matches_jax(apps, arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    files = {"file": ("x.png", buf.getvalue())}
    (status, body), (want_status, want) = _both(apps, "POST", "/api/upload",
                                                files=files)
    assert status == want_status == 200
    assert {k: v for k, v in body.items() if k != "base64_image"} == \
        {k: v for k, v in want.items() if k != "base64_image"}
    np.testing.assert_array_equal(_pixels(body["base64_image"]),
                                  _pixels(want["base64_image"]))


def test_upload_refuses_jpeg_naming_png(apps):
    """A JPEG is served on /api/upload and /api/process as the JAX server
    serves it (within 3: the JAX package decodes with Pillow here, the port
    with the native decoder); a cut JPEG answers 400."""
    data = _jpeg(_image(shape=(24, 32, 3)))
    (status, body), (want_status, want) = _both(
        apps, "POST", "/api/upload", files={"file": ("x.jpg", data)})
    assert status == want_status == 200
    assert {k: v for k, v in body.items() if k != "base64_image"} == \
        {k: v for k, v in want.items() if k != "base64_image"}
    diff = _pixels(body["base64_image"]).astype(int) - _pixels(want["base64_image"])
    assert np.abs(diff).max() <= 3
    url = "data:image/jpeg;base64," + base64.b64encode(data).decode()
    status, body = apps[0].dispatch(Request(
        method="POST", path="/api/process", json={"image": url, "filter": "box"}))
    assert status == 200
    status, body = apps[0].dispatch(Request(
        method="POST", path="/api/upload",
        files={"file": ("x.jpg", data[:len(data) // 2])}))
    assert status == 400 and "Failed to decode image" in body["detail"]


def test_process_refuses_one_bit_png_naming_8_bit(apps):
    """A 1-bit PNG is served as the JAX server serves it; a PNG of a depth
    its colour type does not allow answers 400 naming both."""
    buf = io.BytesIO()
    Image.fromarray(_image()[..., 0] > 127).save(buf, format="PNG")   # mode "1"
    payload = {"image": base64.b64encode(buf.getvalue()).decode(), "filter": "box"}
    (status, body), (want_status, want) = _both(apps, "POST", "/api/process", payload)
    assert status == want_status == 200
    _assert_pixels_close("box", 1, body["processed_image"], want["processed_image"])
    png = bytearray(buf.getvalue())
    png[24] = 3   # bit depth 3
    png[29:33] = zlib.crc32(bytes(png[12:29])).to_bytes(4, "big")
    status, body = apps[0].dispatch(Request(
        method="POST", path="/api/process",
        json={"image": base64.b64encode(bytes(png)).decode(), "filter": "box"}))
    assert status == 400 and "bit depth 3" in body["detail"]


def _jpeg(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def test_process_all_serves_a_jpeg_with_its_passthrough():
    app = create_app(FilterRuntime("cpu"))
    img = _image(9, (20, 28, 3))
    data = _jpeg(img)
    url = "data:image/jpeg;base64," + base64.b64encode(data).decode()
    decoded = decode_base64_image(url)
    before = app.dispatch(Request(method="GET", path="/api/stats"))[1]["decode_tiers"]
    status, body = app.dispatch(Request(method="POST", path="/api/process-all",
                                        json={"image": url, "filter": "gaussian"}))
    assert status == 200
    assert body["original_image"] == url          # the upload, unchanged
    after = app.dispatch(Request(method="GET", path="/api/stats"))[1]["decode_tiers"]
    assert after["native_jpeg"] == before["native_jpeg"] + 1
    for name in ("level_1", "level_2"):
        got = _pixels(body["results"][name]["processed_image"])
        want = app.dispatch(Request(method="POST", path="/api/process", json={
            "image": base64.b64encode(encode_png(decoded)).decode(),
            "filter": "gaussian", "level": int(name[-1])}))[1]
        np.testing.assert_array_equal(got, _pixels(want["processed_image"]))


#: Keys the JAX server adds on the CPU only because its tests turn on
#: placeholder peaks there (tests/conftest.py, GIP_TPU_TEST_PEAKS): the port
#: has no peak table and no device memory to read on the CPU.
NO_CPU_PEAKS = {"compute_throughput_pct", "dram_throughput_pct", "occupancy_pct",
                "peak_device_memory_bytes"}


def _profiled_keys(metrics):
    assert "profiling_error" not in metrics, metrics.get("profiling_error")
    deep = metrics["ncu_data"]
    for section in ("execution", "memory", "occupancy", "config"):
        assert section in deep
    assert metrics["ncu_profiled_time_ms"] == deep["total_kernel_duration_ms"] > 0
    assert metrics["kernel_duration_source"] == deep["duration_source"] == "wall_timing"
    assert metrics["total_kernels"] == len(deep["kernels_profiled"]) >= 1
    return deep


@pytest.mark.parametrize("filt", ["gaussian", "box", "sobel"])
def test_process_all_with_profiling(apps, filt):
    payload = {"image": _png_b64(_image(4, (14, 17, 3))), "filter": filt,
               "radius": 3, "enable_profiling": True}
    (status, body), (want_status, want) = _both(apps, "POST", "/api/process-all",
                                                payload)
    assert status == want_status == 200
    assert body["profiling_available"] is want["profiling_available"] is True
    for name, res in body["results"].items():
        metrics = res["metrics"]
        # The runtime's time stays primary: the profile never replaces it.
        plain = apps[0].dispatch(Request(method="POST", path="/api/process", json={
            **payload, "level": int(name[-1])}))[1]["metrics"]
        assert set(plain) < set(metrics)
        _profiled_keys(metrics)
        assert set(metrics) >= set(want["results"][name]["metrics"]) - NO_CPU_PEAKS
        _assert_pixels_close(filt, 1, res["processed_image"],
                             want["results"][name]["processed_image"])


@pytest.mark.parametrize("filt,level", [("gaussian", 2), ("box", 4), ("sobel", 2)])
def test_process_batch_with_profiling(apps, filt, level):
    images = [_png_b64(_image(seed, (12, 15, 3))) for seed in range(2)]
    payload = {"images": images, "filter": filt, "level": level, "radius": 2,
               "enable_profiling": True}
    (status, body), (want_status, want) = _both(apps, "POST", "/api/process-batch",
                                                payload)
    assert status == want_status == 200
    deep = _profiled_keys(body["metrics"])
    assert deep["config"]["Batch Size"] == 2
    assert deep["config"]["Image Shape"] == "2x12x15x3"
    assert body["metrics"]["batch_size"] == 2
    assert set(body["metrics"]) >= set(want["metrics"]) - NO_CPU_PEAKS


def test_a_profiling_failure_keeps_the_result(monkeypatch):
    from gpu_image_processing_tpu_torch.server import app as app_module

    def broken(*args, **kwargs):
        raise RuntimeError("no trace")

    monkeypatch.setattr(app_module, "profile_filter", broken)
    monkeypatch.setattr(app_module, "profile_batch", broken)
    app = create_app(FilterRuntime("cpu"))
    status, body = app.dispatch(Request(method="POST", path="/api/process-all", json={
        "image": GOOD, "filter": "box", "enable_profiling": True}))
    assert status == 200
    for res in body["results"].values():
        assert res["metrics"]["profiling_error"] == "no trace"
        assert res["metrics"]["time_ms"] > 0 and "ncu_data" not in res["metrics"]
    status, body = app.dispatch(Request(method="POST", path="/api/process-batch", json={
        "images": [GOOD], "filter": "box", "enable_profiling": True}))
    assert status == 200 and body["metrics"]["profiling_error"] == "no trace"


@pytest.mark.parametrize("path", ["/", "/api/health", "/api/filters", "/docs"])
def test_info_endpoints_keep_the_client_keys(apps, path):
    (status, body), (want_status, want) = _both(apps, "GET", path)
    assert status == want_status == 200
    if "gpu_available" in want:
        assert body["gpu_available"] is True
    assert set(body) >= set(want) - {"tpu_available"}
    if path == "/api/filters":
        assert body["filters"].keys() == want["filters"].keys()
        for name, spec in body["filters"].items():
            assert spec["parameters"] == want["filters"][name]["parameters"]


def test_stats_counts_requests_launches_and_phases():
    app = create_app(FilterRuntime("cpu"))
    app.dispatch(Request(method="POST", path="/api/process",
                         json={"image": GOOD, "filter": "sobel", "level": 4}))
    status, stats = app.dispatch(Request(method="GET", path="/api/stats"))
    assert status == 200
    assert stats["requests_by_route"]["POST /api/process"] == 1
    assert stats["device"] == "cpu"
    assert stats["kernel_launches"] == dict(LAUNCHES)
    phases = stats["phase_ms"]["POST /api/process"]
    assert phases["requests"] == 1
    assert all(phases[p] > 0 for p in ("decode", "run", "encode"))
    assert phases["profile"] == 0
    assert stats["decode_tiers"]["zlib_png"] >= 1


def test_without_a_card_the_process_endpoints_answer_503():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    app = create_app()   # asks for the CUDA card, as main() does by default
    for path, payload in [("/api/process", {"image": GOOD, "filter": "box"}),
                          ("/api/process-all", {"image": GOOD, "filter": "box"}),
                          ("/api/process-batch", {"images": [GOOD], "filter": "box"})]:
        status, body = app.dispatch(Request(method="POST", path=path, json=payload))
        assert status == 503 and "CUDA is not available" in body["detail"]
    assert app.dispatch(Request(method="GET", path="/api/health"))[1] == {
        "status": "healthy", "gpu_available": False}
    assert start_runtime("cuda")[0] is None
    assert start_runtime("cpu")[0].device == torch.device("cpu")


def test_warm_kernels_runs_every_level_on_the_cpu():
    rt = FilterRuntime("cpu")
    warm_kernels(rt)
    assert {key[:2] for key in rt._warm} == {
        (f, lv) for f in ("gaussian", "box", "sobel") for lv in (1, 2, 4)}


def test_live_socket_round_trip():
    server = AppServer(create_app(FilterRuntime("cpu")), "127.0.0.1", 0)
    server.start_background()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        img = _image()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/api/process",
            data=json.dumps({"image": _png_b64(img), "filter": "box",
                             "level": 4, "radius": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200 and body["info"]["level"] == "advanced"
        assert _pixels(body["processed_image"]).shape == img.shape
    finally:
        server.shutdown()
