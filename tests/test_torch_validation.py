"""tools/validation.py: the validation matrix on the CPU (the kernels'
plain versions) against the numpy oracle, a few of its cases against the
JAX package's runtime on the same seeded inputs (Pallas in interpret mode,
as the JAX package's tests run it), its gates, and its command line."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_image_processing_tpu.runtime.dispatch import RUNTIME as JAX_RUNTIME
from gpu_image_processing_tpu_torch.runtime.dispatch import FilterRuntime
from gpu_image_processing_tpu_torch.tools import validation
from gpu_image_processing_tpu_torch.core.files import ROOT_DIR
from gpu_image_processing_tpu_torch.tools.verification import Checks

from .sobel_tolerance import assert_sobel_close


@pytest.fixture(scope="module")
def matrix_run():
    """The whole matrix once on the CPU, two oracle processes."""
    return validation.validate(FilterRuntime("cpu"), workers=2)


def test_matrix_passes_on_cpu(matrix_run):
    checks, matrix = matrix_run
    failed = [r for r in checks.records if not r["ok"]]
    assert not failed and checks.failures == 0
    # 3 channel counts x 2 levels x (3 gaussian + 2 box + Sobel), the
    # channels-equal checks of colour Sobel, 3 level-4 gates, 2 rows-vs-planar
    # Sobels, the r = 15 band, 4 batch images and 3 box shapes.
    assert len(checks.records) == 36 + 4 + 3 + 2 + 1 + 4 + 3
    assert len(matrix.cases) == 36 + 1 + 4 + 3


CASES = ["gauss c1 L1 r1", "gauss c3 L2 r3", "gauss c4 L2 r1",
         "box   c1 L2 r1", "box   c3 L2 r15", "sobel c1 L2",
         "sobel c3 L2 (colour gate)", "sobel c4 L1 (colour gate)"]


def assert_gaussian_close(out, want):
    """The port equals the oracle (test_matrix_passes_on_cpu); XLA on the CPU
    contracts the JAX package's tap sums into FMAs, which moves a sum on a
    .5 tie by one, the gaussian envelope of its own soak
    (scripts/soak_fuzz.py:3-16): 3 values of the c3 r3 image here."""
    assert np.abs(out.astype(int) - want).max() <= 1


@pytest.mark.parametrize("label", CASES)
def test_matrix_case_matches_jax(matrix_run, label):
    _, matrix = matrix_run
    out, fn_name, args = matrix.cases[label]
    img = args[0]
    level = int(label.split(" L")[1][0])
    if fn_name == "gaussian_blur":
        radius = args[2]
        sigma = dict(validation.MATRIX_GAUSS)[radius]
        want, _ = JAX_RUNTIME.gaussian_blur(img, sigma=sigma, radius=radius,
                                            level=level)
    elif fn_name == "box_blur":
        want, _ = JAX_RUNTIME.box_blur(img, radius=args[1], level=level)
    else:
        want, _ = JAX_RUNTIME.sobel_edge_detection(img, level=level)
    want = np.asarray(want)
    if fn_name == "sobel" and img.shape[2] > 1:
        assert_sobel_close(out, want)
    elif fn_name == "gaussian_blur":
        assert_gaussian_close(out, want)
    else:
        np.testing.assert_array_equal(out, want)


def test_batch_case_matches_jax(matrix_run):
    _, matrix = matrix_run
    imgs = np.stack([matrix.cases[f"batch gauss L2 image {i}"][2][0]
                     for i in range(4)])
    want, _ = JAX_RUNTIME.run_batch("gaussian", imgs, level=2, sigma=2.0,
                                    radius=3)
    for i in range(4):
        assert_gaussian_close(matrix.cases[f"batch gauss L2 image {i}"][0],
                              np.asarray(want)[i])


def test_gates():
    a = np.zeros((10, 100), np.uint8)
    b = a.copy()
    assert validation.exact(a, b)[0]
    b[0, 0] = 1
    assert not validation.exact(a, b)[0]
    assert validation.within_one(a, b)[0]
    # Colour Sobel: <= 6 on <= 0.1% of 1000 values is one value.
    b[0, 0] = 6
    assert validation.sobel_colour(a, b)[0]
    b[0, 0] = 7
    assert not validation.sobel_colour(a, b)[0]
    b[0, 0], b[0, 1] = 1, 1
    assert not validation.sobel_colour(a, b)[0]
    assert not validation.within_one_rare(a, b)[0]


def test_main_reports_and_exits_on_failure(monkeypatch, tmp_path, capsys):
    def one_case(ok):
        def run_matrix(rt, matrix):
            matrix.holds("planted", ok)
        return run_matrix

    monkeypatch.setattr(validation, "run_matrix", one_case(True))
    assert validation.main(["--device", "cpu", "--workers", "0",
                            "--out-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "TOTAL FAILURES: 0"
    report = json.loads((tmp_path / "validation.json").read_text())
    assert report["failures"] == 0 and report["device"]["platform"] == "cpu"
    monkeypatch.setattr(validation, "run_matrix", one_case(False))
    assert validation.main(["--device", "cpu", "--workers", "0",
                            "--out-dir", str(tmp_path)]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == "TOTAL FAILURES: 1"


def test_raises_without_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validation.main(["--workers", "0", "--out-dir", str(tmp_path)])


def test_checks_count_failures(capsys):
    checks = Checks()
    checks("a", True, "maxdiff 0")
    checks("b", False, "maxdiff 3")
    assert checks.failures == 1
    assert capsys.readouterr().out.splitlines() == [
        "a: OK (maxdiff 0)", "b: MISMATCH (maxdiff 3)"]


def test_oracle_loads_when_a_tool_runs_not_at_import():
    code = ("from gpu_image_processing_tpu_torch.tools import (validation, soak,"
            " sol_report, silicon_ci)\n"
            "from gpu_image_processing_tpu_torch.tools.verification import "
            "load_oracle\n"
            "assert load_oracle.cache_info().currsize == 0\n"
            "assert load_oracle().__file__.endswith('tests/oracle_numpy.py')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT_DIR)
    assert proc.returncode == 0, proc.stderr
