"""The UI mixes a mix file can ask for, on the CPU at small sizes: JPEG
uploads with Exif and slider values on each call run correct through the
`http` entry; each decode fault, a server that ignores the sliders, the
control and a dropped level come out not correct; what a mix may not say
is refused when it is loaded; and the cells that are there build the same
requests and calls as before these abilities, to the byte."""

from __future__ import annotations

import base64
import hashlib
import time

import numpy as np
import pytest

from portbench.harness import client, control, entries, runner, schedule, spec
from portbench.reference import jpeg

UI = "ui_photo.process_all_png"
SEED = 2**33 + 17
SMALL = {"scene": {"height": 40, "width": 56}}
DECODE_TOL = {"max_diff": 4, "max_share_pct": 20.0}
JPEG_MIX = {
    "sizes": [[40, 56], [37, 53]],
    "upload": {"format": "jpeg", "quality": 90, "subsampling": "4:2:0",
               "exif": True},
    "calls": [{"filter": "gaussian", "sigma": 0.5, "radius": 1},
              {"filter": "gaussian", "sigma": 20.0, "radius": 15},
              {"filter": "box", "radius": 8},
              {"filter": "box", "radius": 3},
              {"filter": "sobel"}],
    "sample": 16,
}


def _numerics() -> dict:
    numerics = spec.load(UI).config["numerics"]
    return {**numerics, "within_tolerance": {
        **numerics["within_tolerance"], "jpeg_decode": DECODE_TOL}}


def _run(mix: dict, alter=None, seconds: float = 0.6) -> dict:
    return runner.run_cell(UI, SEED, seconds, False, time.perf_counter(),
                           device="cpu", alter=alter, mix_overrides=mix,
                           config_overrides={**SMALL, "numerics": _numerics()})


def test_a_jpeg_mix_with_sliders_runs_correct(monkeypatch):
    seen = []
    counters = entries.HttpEntry.counters

    def keep(self):
        seen.append(counters(self))
        return seen[-1]

    monkeypatch.setattr(entries.HttpEntry, "counters", keep)
    result = _run(JPEG_MIX)
    assert result["correct"], result["checked"]
    assert result["failed"] == 0 and result["attempted"] > 0
    checked = result["checked"]
    assert checked["decode_bytes_beyond_tol"] == [0, 0]
    assert 0 <= checked["decode_worst_share_pct"][0] <= 20.0
    assert checked["decode_worst_share_pct"][1] == 20.0
    assert list(checked)[-1] == "unreadable_answers"
    before, after = seen
    assert after["decode_tiers"].get("native_jpeg", 0) > before[
        "decode_tiers"].get("native_jpeg", 0)
    assert "encode_bands" in after and "executables" in after


def test_a_png_run_prints_no_decode_number():
    result = _run({"sizes": [[40, 56]]})
    assert result["correct"], result["checked"]
    assert not any(k.startswith("decode_") for k in result["checked"])


def _planted_decode(monkeypatch, fault):
    """The server's upload decode replaced by what a decoder with `fault`
    makes of each JPEG the writer wrote."""
    from gpu_image_processing_tpu_torch.server import app

    written = {}
    encode = jpeg.encode

    def recording(img, *args, **kw):
        out = encode(img, *args, **kw)
        written[out.data] = (img, out)
        return out

    def decode(b64: str):
        img, w = written[base64.b64decode(b64.split(",", 1)[1])]
        return fault(img, w), None

    monkeypatch.setattr(jpeg, "encode", recording)
    monkeypatch.setattr(app, "decode_base64_image_ex", decode)


def _up(w, p):
    return jpeg.upsample_h2v2(p, w.height, w.width)


def _nearest(w, p):
    return np.repeat(np.repeat(p, 2, 0), 2, 1)[:w.height, :w.width]


def _swapped(img, w):
    y, cb, cr = jpeg.component_planes(w)
    return jpeg.ycc_to_rgb(y, _up(w, cr), _up(w, cb))


def _nearest_chroma(img, w):
    y, cb, cr = jpeg.component_planes(w)
    return jpeg.ycc_to_rgb(y, _nearest(w, cb), _nearest(w, cr))


def _quality_off(img, w):
    return jpeg.decode(jpeg.encode(img, 89, w.subsampling, True))


@pytest.mark.parametrize("fault", [_swapped, _nearest_chroma, _quality_off],
                         ids=["swapped_chroma", "nearest_chroma",
                              "quality_one_step_off"])
def test_a_decode_fault_is_not_correct(monkeypatch, fault):
    _planted_decode(monkeypatch, fault)
    result = _run(JPEG_MIX)
    assert not result["correct"]
    assert result["checked"]["decode_bytes_beyond_tol"][0] > 0


def test_the_reference_decode_planted_is_correct(monkeypatch):
    """The planting itself is sound: the reference decode in the server's
    place passes, so a fault above is refused for what it decodes."""
    _planted_decode(monkeypatch, lambda img, w: jpeg.decode(w))
    result = _run(JPEG_MIX)
    assert result["correct"], result["checked"]
    assert result["checked"]["decode_worst_share_pct"][0] == 0


def test_a_server_that_uses_the_configurations_radius_is_not_correct():
    stated = spec.load(UI).config["filters"]

    def configs_radius(kind, fn):
        def run(filter_name, image, **kw):
            if "radius" in kw:
                kw["radius"] = stated[filter_name]["radius"]
            return fn(filter_name, image, **kw)
        return run

    result = _run(JPEG_MIX, configs_radius)
    assert not result["correct"]
    assert result["checked"]["exact_bytes_off"][0] > 0


@pytest.mark.parametrize("name", ["control", "dropped_level"])
def test_the_control_and_a_dropped_level_on_the_jpeg_mix(name):
    alter = control.control if name == "control" else control.FAULTS[name]
    result = _run(JPEG_MIX, alter)
    assert not result["correct"], result["checked"]


@pytest.mark.parametrize("change,match", [
    ({"exif": False}, "exif"),
    ({"subsampling": "4:2:2"}, "subsampling"),
    ({"quality": 0}, "quality"),
    ({"format": "webp"}, "jpeg"),
])
def test_a_jpeg_mix_that_cannot_stand_is_refused(change, match):
    mix = {**JPEG_MIX, "upload": {**JPEG_MIX["upload"], **change}}
    with pytest.raises(ValueError, match=match):
        spec.load(UI, mix_overrides=mix,
                  config_overrides={"numerics": _numerics()})


def test_a_jpeg_mix_on_a_configuration_without_a_decode_tolerance():
    with pytest.raises(ValueError, match="jpeg_decode"):
        spec.load(UI, mix_overrides=JPEG_MIX)


def test_a_template_key_or_an_upload_a_mix_may_not_have_is_refused():
    with pytest.raises(ValueError, match="template 0"):
        spec.load(UI, mix_overrides={"calls": [{"filter": "gaussian",
                                                "sigmaa": 3.0}]})
    with pytest.raises(ValueError, match="template 0"):
        spec.load(UI, mix_overrides={"calls": [{"filter": "median"}]})
    with pytest.raises(ValueError, match="only the http entry"):
        spec.load("lib_photo.api_repeat",
                  mix_overrides={"upload": JPEG_MIX["upload"]})


def test_a_template_takes_its_own_values_first():
    config = spec.load(UI).config
    mix = {"sizes": [[8, 8]], "calls": [{"filter": "gaussian", "sigma": 8.0,
                                         "radius": 12},
                                        {"filter": "box", "radius": 15},
                                        {"filter": "gaussian"}]}
    got = [(c.template, c.sigma, c.radius)
           for c in schedule.distinct_work(mix, config)]
    assert got == [(0, 8.0, 12), (1, 2.0, 15), (2, 2.0, 3)]


# The cells that are there, before templates could carry values and uploads
# could be JPEGs: the UI cell's plan (each request's body in plan order) and
# its distinct bodies at 40x56 and SEED, and each cell's first 600 calls.
# Taken from the code before the change; the PNGs are zlib's level 6.
PLAN_SHA256 = "9dee16f1799fcbc4be224257a7302b4b23d97bb0cff8fb6970a1053166180130"
BODY_SHA256 = [
    "7303aa2389c5e27e02d99e8054328a59e5cb10f5743adff55dbe7f8a4265aa13",
    "394f54df60e60b304bec9a42bc987a866b7f913c60e6d697d1d5d9914f34f5d2",
    "e92a21c77b0a25dd074d62f7307897d0b14d6335925de2cf0a9f79ed3743e7fe",
    "475d2f40f6945eba7b64c429b6362335ea458115b0c0db91d7c1965559121275",
    "669913af2a118afb4c68bf61d6010a7279ac376b0a3462cd3d5068eb904905e0",
    "16c3b0135d4e8c07391699e8a70e0bc5fdda31342a45148a1999b68776e48f04"]
CALLS_SHA256 = {
    "ui_photo.process_all_png":
        "d9301226508b3ba28fbee414acd885ed8a5ce9079717380c36096fc3663c4ce4",
    "lib_photo.api_repeat":
        "f06e2bb4b9d44927297c9116e39ffc2dc3caeed2d4a3679b19f7ed7ade92993c",
    "lib_photo.forward_frames":
        "074961448c5068b5c97628ad477f2185ec521fc81253c8534f67b150398106a9",
    "lib_photo_r15.forward_frames":
        "1981ac837a1250c4eb42c03633d0d0b3e8d1ba430a4f69ba1bc9c1cae3be4a80"}


class _Planned(Exception):
    pass


def _requests(monkeypatch, mix: dict) -> tuple[str, list[str]]:
    """The UI cell's plan hash and distinct body hashes, from the entry's
    setup stopped where it hands the plans to the clients."""
    captured = {}

    def plan_only(self):
        self.plans = [self._plan(c) for c in range(int(self.ctx.mix["clients"]))]
        captured["entry"] = self
        raise _Planned

    monkeypatch.setattr(entries.HttpEntry, "_start_clients", plan_only)
    with pytest.raises(_Planned):
        runner.run_cell(UI, SEED, 0.2, False, time.perf_counter(),
                        device="cpu", mix_overrides=mix,
                        config_overrides=SMALL)
    e = captured["entry"]
    e.server.shutdown()
    bodies = {}
    for u, t in e.plans[0]:
        bodies.setdefault((u, t), client._body(e.uploads[u].url, e.fields[t]))
    plan = hashlib.sha256()
    for key in e.plans[0]:
        plan.update(hashlib.sha256(bodies[key]).digest())
    return plan.hexdigest(), [hashlib.sha256(b).hexdigest()
                              for b in bodies.values()]


@pytest.mark.parametrize("mix", [
    {"sizes": [[40, 56]]},
    {"sizes": [[40, 56]],
     "calls": [{"filter": "gaussian", "sigma": 2.0, "radius": 3},
               {"filter": "box", "sigma": 2.0, "radius": 3},
               {"filter": "sobel", "sigma": 2.0, "radius": 3}]},
], ids=["as_the_cell_is", "templates_carrying_the_stated_values"])
def test_the_ui_cell_sends_the_same_bytes(monkeypatch, mix):
    plan, bodies = _requests(monkeypatch, mix)
    assert plan == PLAN_SHA256
    assert bodies == BODY_SHA256


@pytest.mark.parametrize("cell", sorted(CALLS_SHA256))
def test_each_cell_draws_the_same_calls(cell):
    c = spec.load(cell)
    calls = schedule.calls(c.mix, c.config,
                           np.random.default_rng([SEED, 2]))
    seq = [(k.filter, k.level, k.sigma, k.radius, k.size, k.image)
           for k in (next(calls) for _ in range(600))]
    assert hashlib.sha256(repr(seq).encode()).hexdigest() == CALLS_SHA256[cell]
