"""What the benchmark may import: never JAX or the JAX package, and in the
reference nothing of the program and not Pillow."""

from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gpu_image_processing_tpu"}
PORT = "gpu_image_processing_tpu_torch"


def _imports(path: Path) -> set[str]:
    """The top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = _imports(path) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_the_comparison_is_by_whole_top_level_name():
    # The port's name begins with the JAX package's: a prefix match would
    # refuse every file that imports the port.
    assert PORT.startswith("gpu_image_processing_tpu")
    assert PORT not in FORBIDDEN


def test_the_reference_and_the_inputs_import_nothing_of_the_program():
    for sub in ("reference", "inputs"):
        for path in sorted((BENCH / sub).rglob("*.py")):
            imports = _imports(path)
            assert PORT not in imports and "portbench" not in imports - {
                "portbench"} and not imports & FORBIDDEN, path


def test_the_reference_decodes_and_encodes_without_pillow():
    """The JPEG and PNG yardsticks are plain code: a decoder that Pillow
    or the program shares would judge itself."""
    paths = sorted((BENCH / "reference").rglob("*.py"))
    assert BENCH / "reference" / "jpeg.py" in paths
    for path in paths:
        assert not _imports(path) & {"PIL", "Pillow"}, path


def test_the_client_runs_on_the_standard_library_alone():
    import sys

    stdlib = sys.stdlib_module_names
    imports = _imports(BENCH / "harness" / "client.py") - {"__future__"}
    assert imports <= stdlib, imports - stdlib
