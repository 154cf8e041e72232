"""Seeded input images: a dead-leaves scene and the pools derived from it.

`scene_image` is a frozen copy of `chip_smoke.py::scene_image` (the
smoke's upload scene), with the shape as an argument: occluding discs with
radii of density r^-3 (3 to 1200 pixels), a 1/f texture over them and
sensor noise, the statistics of natural photographs, so that the codec and
the kernels see the work a photo gives them.  A pool is that one scene and
seeded flips, rolls and crops of it, so that making inputs stays a small
part of a run's set-up.
"""

from __future__ import annotations

import numpy as np


def scene_image(rng: np.random.Generator, shape: tuple[int, int, int]
                ) -> np.ndarray:
    """An (H, W, 3) uint8 dead-leaves scene drawn from `rng`."""
    h, w, _ = shape
    img = np.empty(shape, np.float32)
    img[:] = rng.uniform(0, 255, 3)
    n = h * w // 145
    rmin, rmax = 3.0, 1200.0
    radii = 1 / np.sqrt(1 / rmin**2 - rng.uniform(size=n)
                        * (1 / rmin**2 - 1 / rmax**2))
    for r, cy, cx, col in zip(radii, rng.uniform(0, h, n),
                              rng.uniform(0, w, n),
                              rng.uniform(0, 255, (n, 3)).astype(np.float32)):
        y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, h)
        x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, w)
        yy = np.arange(y0, y1)[:, None] - cy
        xx = np.arange(x0, x1)[None, :] - cx
        img[y0:y1, x0:x1][yy * yy + xx * xx <= r * r] = col
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    spec = (rng.standard_normal(f.shape)
            + 1j * rng.standard_normal(f.shape)) / f
    spec[0, 0] = 0
    texture = np.fft.irfft2(spec, s=(h, w))
    img += (12 / texture.std() * texture).astype(np.float32)[:, :, None]
    img += rng.normal(0, 2.0, shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def variant(scene: np.ndarray, rng: np.random.Generator, height: int,
            width: int) -> np.ndarray:
    """A contiguous (height, width, 3) image cut from `scene`, mirrored at
    its edges where the size is larger, at a seeded offset, flipped and
    rolled by seeded amounts."""
    sh, sw, _ = scene.shape
    if height > sh or width > sw:
        scene = np.pad(scene, ((0, max(height - sh, 0)),
                               (0, max(width - sw, 0)), (0, 0)),
                       mode="symmetric")
        sh, sw, _ = scene.shape
    y = int(rng.integers(0, sh - height + 1))
    x = int(rng.integers(0, sw - width + 1))
    img = scene[y:y + height, x:x + width]
    if rng.integers(2):
        img = img[::-1]
    if rng.integers(2):
        img = img[:, ::-1]
    img = np.roll(img, (int(rng.integers(height)), int(rng.integers(width))),
                  axis=(0, 1))
    return np.ascontiguousarray(img)


def pool(rng: np.random.Generator, scene_shape: tuple[int, int],
         sizes: list[tuple[int, int]], per_size: int
         ) -> dict[tuple[int, int], list[np.ndarray]]:
    """`per_size` images of each (H, W) in `sizes`, from one scene of
    `scene_shape` (H, W): the first image of that size is the scene
    itself, every other one a variant of it."""
    scene = scene_image(rng, (*scene_shape, 3))
    out: dict[tuple[int, int], list[np.ndarray]] = {}
    for h, w in sizes:
        imgs = [variant(scene, rng, h, w) for _ in range(per_size)]
        if (h, w) == tuple(scene_shape):
            imgs[0] = scene
        out[(h, w)] = imgs
    return out
