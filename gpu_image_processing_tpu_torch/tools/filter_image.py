"""Filter an image file from the command line.

The port's counterpart of the JAX package's `scripts/filter_image.py`,
itself the analog of the reference's `tests/test_real_image.cu` CLI: load
any format, check sigma and radius, filter through the `gpu_filters` API,
write the format the output extension names (.png, .ppm, .pgm, .bmp, .tga,
.hdr, .jpg; utils/image_io.py), then print the metrics and the 30/60 FPS
verdicts.  It filters on the CUDA card (the rows kernels) unless
`--device cpu` asks for the CPU; without CUDA it raises.

Usage:
    python -m gpu_image_processing_tpu_torch.tools.filter_image INPUT [OUTPUT]
        [--filter gaussian|box|sobel] [--level 1|2|4] [--sigma 2.0]
        [--radius 3] [--frames] [--load ldr|16|float] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..api import filters as api
from ..core import config
from ..runtime.dispatch import FilterRuntime
from ..utils.image import decode_file_16, decode_file_float
from ..utils.image_io import load_frames, load_image, save_image


def _filter(args, runtime: FilterRuntime, img: np.ndarray) -> dict:
    if args.filter == "gaussian":
        return api.gaussian_blur(img, sigma=args.sigma, radius=args.radius,
                                 level=args.level, runtime=runtime)
    if args.filter == "box":
        return api.box_blur(img, radius=args.radius, level=args.level,
                            runtime=runtime)
    return api.sobel_edge_detection(img, level=args.level, runtime=runtime)


def _default_output(args) -> str:
    return (os.path.splitext(args.input)[0]
            + f"_{args.filter}_l{args.level}.png")


def run_frames(args, runtime: FilterRuntime) -> int:
    """Filter every frame of an animated GIF; OUT_f000.png, OUT_f001.png..."""
    frames, delays, tier = load_frames(args.input)
    n, h, w, _ = frames.shape
    print(f"Loaded {args.input}: {n} frame(s), {w}x{h} ({tier} tier), "
          f"delays(ms)={list(delays)}")
    stem, _ = os.path.splitext(args.output or _default_output(args))
    total_ms = 0.0
    for i in range(n):
        result = _filter(args, runtime, np.ascontiguousarray(frames[i]))
        total_ms += result["time_ms"]
        out_path = f"{stem}_f{i:03d}.png"
        save_image(out_path, result["image"])
        print(f"  frame {i}: {result['time_ms']:.3f} ms -> {out_path}")
    print(f"Total device time: {total_ms:.3f} ms for {n} frames")
    return 0


def _load_wide(args) -> np.ndarray:
    """The `--load 16|float` decode, reduced to uint8 as stb reduces it."""
    with open(args.input, "rb") as f:
        raw = f.read()
    if args.load == "16":
        wide = decode_file_16(raw)
        print(f"Loaded {args.input} as uint16: range "
              f"[{int(wide.min())}, {int(wide.max())}] "
              f"({wide.shape[2]} channel(s))")
        img = (wide >> 8).astype(np.uint8)   # stb's 16 -> 8: v >> 8
    else:
        wide = decode_file_float(raw)
        print(f"Loaded {args.input} as linear float32: range "
              f"[{wide.min():.4g}, {wide.max():.4g}] "
              f"({wide.shape[2]} channel(s))")
        # stb's hdr_to_ldr default tone map (gamma 2.2, scale 1).
        ldr = np.power(np.clip(wide, 0.0, None),
                       np.float32(1 / 2.2)) * 255.0 + 0.5
        img = np.clip(ldr, 0, 255).astype(np.uint8)
    if img.shape[2] == 4:
        img = np.ascontiguousarray(img[:, :, :3])
    elif img.shape[2] == 2:
        img = np.ascontiguousarray(img[:, :, :1])
    return img


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("input")
    parser.add_argument("output", nargs="?", default=None)
    parser.add_argument("--filter", default="gaussian",
                        choices=["gaussian", "box", "sobel"])
    parser.add_argument("--level", type=int, default=2,
                        help="1 (naive), 2 (optimized) or 4 (advanced)")
    parser.add_argument("--sigma", type=float, default=config.DEFAULT_SIGMA)
    parser.add_argument("--radius", type=int, default=config.DEFAULT_RADIUS)
    parser.add_argument("--frames", action="store_true",
                        help="filter every frame of an animated GIF; outputs "
                             "OUT_f000.png, OUT_f001.png, ...")
    parser.add_argument("--load", choices=["ldr", "16", "float"],
                        default="ldr",
                        help="'ldr' = 8-bit (default); '16' = stbi_load_16 "
                             "analog (PNG/PSD at their 16 bits, others v*257; "
                             "filters the high byte); 'float' = stbi_loadf "
                             "analog (Radiance HDR as linear floats, LDR "
                             "(v/255)^2.2; filters the stb tone map)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without CUDA) or cpu")
    args = parser.parse_args(argv)

    # The reference CLI's checks (test_real_image.cu:77-85).
    lo, hi = config.SIGMA_RANGE
    if not lo <= args.sigma <= hi:
        print(f"Error: sigma must be in [{lo}, {hi}]")
        return 1
    rlo, rhi = config.RADIUS_RANGE
    if not rlo <= args.radius <= rhi:
        print(f"Error: radius must be in [{rlo}, {rhi}]")
        return 1

    runtime = FilterRuntime(args.device)
    if args.frames:
        return run_frames(args, runtime)
    img = _load_wide(args) if args.load != "ldr" else load_image(args.input)
    h, w, c = img.shape
    print(f"Loaded {args.input}: {w}x{h}, {c} channel(s)")

    result = _filter(args, runtime, img)
    out_path = args.output or _default_output(args)
    save_image(out_path, result["image"])

    t = result["time_ms"]
    print(f"Filter: {args.filter} level {args.level}")
    print(f"  Time:      {t:.3f} ms")
    print(f"  Bandwidth: {result['bandwidth_gbps']:.2f} GB/s")
    print(f"  FPS:       {result['fps']:.2f}")
    # 30/60 FPS verdicts, as in test_real_image.cu:259-265.
    for target in (30, 60):
        budget = 1000.0 / target
        verdict = "meets" if t <= budget else "misses"
        print(f"  {verdict} {target} FPS target ({budget:.1f} ms budget)")
    print(f"Saved: {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
