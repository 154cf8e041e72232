"""The one packaging step pyproject.toml cannot declare: the wheel carries
the repository files the PyTorch port builds from at run time, which lie
outside its package.

`build_py` copies each file of `CARRIED` (the C++ sources of the codec's
library in `native/src`: PNG on zlib, the upload decoders, the file
writers) into the built package at
`gpu_image_processing_tpu_torch/_carried/<its path from the root>`, where
`gpu_image_processing_tpu_torch/core/files.py` looks first.  The source tree
is not touched.  Build offline, from the root of the repository:

    pip wheel --no-deps --no-build-isolation -w DIST .
"""

import importlib.util
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py

ROOT = Path(__file__).resolve().parent


def _files_module():
    # core/files.py alone (it imports nothing of the package), so that the
    # build needs no torch.
    path = ROOT / "gpu_image_processing_tpu_torch" / "core" / "files.py"
    spec = importlib.util.spec_from_file_location("_gip_torch_files", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class BuildPyCarrying(build_py):
    def run(self):
        super().run()
        files = _files_module()
        carried = Path(self.build_lib) / files.CARRIED_DIR.relative_to(ROOT)
        for relative in files.CARRIED:
            target = carried / relative
            self.mkpath(str(target.parent))
            self.copy_file(str(ROOT / relative), str(target))


setup(cmdclass={"build_py": BuildPyCarrying})
