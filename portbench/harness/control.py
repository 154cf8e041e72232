"""What the comparison has to refuse: the control and the planted faults.

Each is an `alter(kind, fn)` for `runner.run_cell`, which puts it in the
program's place underneath the entry that the window drives:

* `control`: the plain reference in bfloat16, the precision below the
  configuration's float32, in the program's place;
* `unchanged`: every call answers its input unchanged (a step that
  returns its state);
* `dropped_level`: the server's level-2 run fails, so that it answers
  200 with level 1 alone (half of the route's work left out; the cells
  call on one image, so no batch can lose half its rows);
* `altered`: the program's answer with one pixel (its centre) moved by
  128 where it is produced.

`limits.py` runs the control on the card; `tests/` runs all of them on the
CPU and sees `correct` come out false.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import filters as reference


def _bf16(img: torch.Tensor, filter_name: str, level: int, sigma: float,
          radius: int) -> torch.Tensor:
    return reference.apply(img, filter_name, level, sigma, radius,
                           torch.bfloat16)


def control(kind: str, fn):
    if kind == "http":
        def run(filter_name, image, level=1, sigma=2.0, radius=3):
            _, metrics = fn(filter_name, image, level=level, sigma=sigma,
                            radius=radius)
            return _bf16(torch.tensor(image), filter_name, level, sigma,
                         radius).numpy(), metrics
        return run
    if kind == "api":
        def api(call, image):
            dev = "cuda" if torch.cuda.is_available() else "cpu"
            return _bf16(torch.from_numpy(image).to(dev), call.filter,
                         call.level, call.sigma, call.radius).cpu().numpy()
        return api
    return lambda call, frame: _bf16(frame, call.filter, call.level,
                                     call.sigma, call.radius)


def unchanged(kind: str, fn):
    if kind == "http":
        return lambda filter_name, image, **kw: (
            image.copy(), fn(filter_name, image, **kw)[1])
    return lambda call, image: image.clone() if isinstance(
        image, torch.Tensor) else image.copy()


def dropped_level(kind: str, fn):
    def run(filter_name, image, level=1, **kw):
        if level == 2:
            raise RuntimeError("planted: level 2 left out")
        return fn(filter_name, image, level=level, **kw)
    return run if kind == "http" else fn


def _poke(out):
    h, w = out.shape[-3:-1]
    if isinstance(out, torch.Tensor):
        out = out.clone()
        out[..., h // 2, w // 2, :] += 128
        return out
    out = np.array(out)
    out[..., h // 2, w // 2, :] += np.uint8(128)
    return out


def altered(kind: str, fn):
    if kind == "http":
        def run(*args, **kw):
            out, metrics = fn(*args, **kw)
            return _poke(out), metrics
        return run
    return lambda call, image: _poke(fn(call, image))


FAULTS = {"unchanged": unchanged, "dropped_level": dropped_level,
          "altered": altered}
