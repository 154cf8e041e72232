"""tools/soak.py: the randomized soak on the CPU (the kernels' plain
versions) against the numpy oracle, a planted fault that its gates must
catch, its draws against the JAX soak's, and its shapes at the tile edges."""

import json

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu_torch.ops.cuda import blur, blur_planar
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.tools import soak


def _run(tmp_path, *args):
    return soak.main([*args, "--device", "cpu", "--workers", "2",
                      "--out-dir", str(tmp_path)])


def test_soak_passes_on_cpu(tmp_path, capsys):
    assert _run(tmp_path, "30") == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "SOAK DONE: 0 failures"
    report = json.loads((tmp_path / "soak.json").read_text())
    assert [s["trials"] for s in report["sections"]] == [30, 15, 10]
    assert report["failures"] == 0 and report["seed"] == soak.SEED
    # Every shape a key, the runtime's executables stay within the limit.
    held = [s["executables"] for s in report["sections"]]
    assert [h["executables"] for h in held[:2]] == [8, 8]
    assert all(h["executables"] <= h["limit"] == 8 for h in held)


def test_planted_fault_fails_the_soak(tmp_path, monkeypatch, capsys):
    # The level-2 gaussian's plain version, off by one at the last column:
    # the gates must see it, and the soak must exit 1.
    plain = blur.gaussian_rows_plain

    def off_by_one(rows, weights, radius, channels):
        out = plain(rows, weights, radius, channels).clone()
        last = out[..., -channels:]
        out[..., -channels:] = torch.where(last < 255, last + 1, last - 1)
        return out

    monkeypatch.setattr(blur, "gaussian_rows_plain", off_by_one)
    assert _run(tmp_path, "6") == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out and "GAUSS" in out
    assert out.splitlines()[-1] != "SOAK DONE: 0 failures"
    report = json.loads((tmp_path / "soak.json").read_text())
    assert report["failures"] > 0


def _jax_section_draws(rng, n):
    """scripts/soak_fuzz.py:41-74's draws, line for line."""
    trials = []
    for trial in range(n):
        if trial % 3 == 0:
            base = int(rng.integers(1, 4)) * 64
            h = base + int(rng.integers(-3, 4))
            h = max(h, 1)
        else:
            h = int(rng.integers(1, 200))
        w = int(rng.integers(3, 200))
        c = int(rng.choice([1, 3, 4]))
        img = rng.integers(0, 256, (h, w, c), np.uint8)
        kind = int(rng.integers(0, 3))
        lvl = int(rng.choice([1, 2, 4]))
        r = sigma = None
        if kind == 0:
            r = int(rng.integers(1, 16))
            sigma = float(rng.uniform(0.5, 8))
        elif kind == 1:
            r = int(rng.integers(1, 30))
        trials.append((trial, h, w, c, lvl, kind, r, sigma, img))
    return trials


class _Recorder:
    """An oracle pool that records what it is asked and answers nothing."""

    def __init__(self):
        self.calls = []

    def submit(self, fn_name, *args):
        self.calls.append((fn_name, args))


def test_section_1_keeps_the_jax_soaks_trials():
    n = 30
    recorder = _Recorder()
    soak.section_rows(FilterRuntime("cpu"), recorder,
                      np.random.default_rng(soak.SEED),
                      np.random.default_rng([soak.SEED, 1]), n)
    jax = _jax_section_draws(np.random.default_rng(soak.SEED), n)
    assert len(recorder.calls) == n
    for (trial, h, w, c, lvl, kind, r, sigma, img), (fn_name, args) in zip(
            jax, recorder.calls):
        assert fn_name == ("gaussian_blur", "box_blur", "sobel")[kind]
        if trial % 3 == 1:
            # A shape at the tile edges from the second generator instead.
            assert args[0].shape[2] == c
            continue
        np.testing.assert_array_equal(args[0], img)
        if kind == 0:
            assert args[2] == r
        elif kind == 1:
            assert args[1] == r
        else:
            assert args[1] == (1 if lvl == 4 else lvl)


def test_section_3_draws_the_folded_planar_gaussian(monkeypatch):
    """The default run's planar section (N = 150: 50 trials, its own
    generator) reaches the folded planar gaussian in at least 5 trials; on
    the card the soak fails unless it launched there."""
    launches = []
    folded = blur_planar.gaussian_folded_planar

    def counted(*args, **kwargs):
        launches.append(args[0].shape)
        return folded(*args, **kwargs)

    monkeypatch.setattr(blur_planar, "gaussian_folded_planar", counted)
    sec = soak.section_planar(FilterRuntime("cpu"), _Recorder(),
                              np.random.default_rng([soak.SEED, 2]),
                              soak.TRIALS // 3)
    assert not sec.errors
    assert len(sec.trials) == soak.TRIALS // 3
    assert len(launches) >= 5


@pytest.mark.parametrize("c", [1, 3, 4])
def test_edge_shapes_sit_on_the_tile_edges(c):
    rng = np.random.default_rng(7)
    for _ in range(200):
        h, w = soak.edge_shape(rng, c)
        lanes = w * c
        assert min(lanes % 128, -lanes % 128) <= 3 * c
        assert min(h % 8, -h % 8) <= 3 and h >= 1


def test_planar_shapes():
    rng = np.random.default_rng(7)
    for _ in range(200):
        h, w = soak.planar_shape(rng)
        assert min(w % 512, -w % 512) <= 3 and 509 <= w <= 1027
        assert min(h % 8, -h % 8) <= 3 and h >= 3


def test_raises_without_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.main(["3", "--workers", "0", "--out-dir", str(tmp_path)])
