"""The blur kernels of `blur.cu` and their plain torch versions.

* `gaussian_rows` replaces the TPU kernel `ops/pallas/blur.py::_blur_kernel`
  (level 2); `gaussian_folded_rows` replaces it with `folded=True` (level 4,
  r < 3).  One launch (`gauss_window_rows`): the intermediate in shared
  memory, the radius a template parameter at the radii the paths use, the
  taps a kernel parameter passed by value, register windows for the
  level-2 tap order; bit-exact.  1 <= r <= `GAUSS_MAX_RADIUS`, at most
  `GAUSS_MAX_CHANNELS` channels on the card.
* `gaussian_band_rows` replaces `ops/pallas/blur_mxu.py::_gauss_mxu_kernel`
  in gaussian mode (level 4, r >= 3): the bf16 hi + lo band products of
  both passes on the tensor cores in one launch (`band_mma_rows`).  The
  tensor cores sum in their own order, so it is held to maxdiff <= 1 on at
  most 0.1% of bytes against its tap-order plain version (`BAND_MAX_DIFF`,
  `BAND_MAX_FRACTION`), as the TPU kernel was held to level 4's "within 1 of
  level 2"; it is deterministic, and a batch equals its single launches.
* `box_rows` replaces `_blur_kernel` in box mode and `_gauss_mxu_kernel` in
  box mode, at levels 2 and 4: integer window sums, exact in any order, so
  bit-exact.  Routed on the radius: to r = 7 the gaussian's window kernel
  with plain sums (`gauss_window_rows<Box, r>`), then up to
  `BOX_WINDOW_MAX_RADIUS` one launch of running sums with the intermediate
  in shared memory (`box_window_rows`), past it two launches through device
  memory (`box_wide_h`, `box_wide_v`),
  whose first window is summed in closed form, so a radius wider than the
  image costs O(W) and O(H) loads a segment, not O(r).

Each launch is counted by its wrapper's name (`LAUNCHES`) and by the device
function it ran (`ROUTES`), which `route` asks of `blur.cu`
(`gip_blur_route`), from the rules that pick the function, once per launch
plan (`plan.py`, `plan_for`).

Each takes (H, W*C) uint8 rows or a (B, H, W*C) batch of them, which one
launch filters image by image.  On a CPU tensor a wrapper returns the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core import spans
from .. import interleaved
from ..weights import box_inv_taps_f32
from . import build, plan

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gip_gaussian_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gip_gaussian_folded_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gip_gaussian_band_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gip_box_window_rows": [_P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _P],
    "gip_box_wide_rows": [_P, _P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _P],
    # The planar blur (blur_planar.py): the window kernels at one channel.
    "gip_gaussian_planar": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gip_gaussian_folded_planar": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gip_box_planar": [_P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _P],
    "gip_blur_route": [_I, _I, _I],
}

#: The grid's z dimension, which carries the batch, holds at most this many.
MAX_BATCH = 65535
#: The gaussian kernel's radii: 2r + 1 <= MAX_KERNEL_TAPS (core/config.py);
#: its channels: a thread computes 16 pixels of one channel, and a strip
#: holds at most 512 lanes.
GAUSS_MAX_RADIUS = 31
GAUSS_MAX_CHANNELS = 32
#: Box radii up to this run in one launch (a shared ring of 2r + 16 rows);
#: wider ones take the two-launch running sum.
BOX_WINDOW_MAX_RADIUS = 64
#: A box strip holds at most 512 lanes and at least 32 pixels.
BOX_MAX_CHANNELS = 16
#: The band's radii: 2r + 1 <= MAX_KERNEL_TAPS (core/config.py); its
#: staged tile (taps C lanes apart) fits shared memory up to 4 channels.
BAND_MAX_RADIUS = 31
BAND_MAX_CHANNELS = 4
#: The band kernel against its plain version: at most this difference, on
#: at most this fraction of bytes (sums in the tensor cores' order).
BAND_MAX_DIFF, BAND_MAX_FRACTION = 1, 1e-3

# The plain versions: the kernels' functions in plain torch ops.
gaussian_rows_plain = interleaved.gaussian_rows
gaussian_folded_rows_plain = interleaved.gaussian_rows_folded
gaussian_band_rows_plain = interleaved.gaussian_rows_band
box_rows_plain = interleaved.box_rows


def check_rows(rows: torch.Tensor, channels: int) -> tuple[int, int, int]:
    """(batch, height, width) of contiguous (H, W*C) or (B, H, W*C) uint8
    rows; raises otherwise."""
    shape = rows.shape
    if (rows.dtype != torch.uint8 or len(shape) not in (2, 3)
            or not rows.is_contiguous()):
        raise ValueError(
            f"expected contiguous (H, W*C) or (B, H, W*C) uint8 rows; got "
            f"{rows.dtype} {tuple(shape)}")
    lanes = shape[-1]
    if channels < 1 or lanes % channels:
        raise ValueError(
            f"row width {lanes} is not a multiple of {channels} channels")
    batch = shape[0] if len(shape) == 3 else 1
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch of {batch} images; one launch takes 1 to "
                         f"{MAX_BATCH}")
    return batch, shape[-2], lanes // channels


def check_table(table: torch.Tensor, rows: torch.Tensor, radius: int,
                 name: str, on_host: bool = False) -> None:
    """Raise unless `table` is a contiguous (2r+1,) float32 tensor on
    `rows`' device (or on the host, if `on_host`)."""
    if ((not (on_host and table.is_cpu) and table.device != rows.device)
            or table.dtype != torch.float32
            or table.shape != (2 * radius + 1,)
            or not table.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous ({2 * radius + 1},) float32 tensor "
            f"on {rows.device}" + (" or the host" if on_host else ""))


def library(device: torch.device) -> ctypes.CDLL:
    """blur.cu's library, built first if needed."""
    return build.load("blur", device, _SIGNATURES)


#: `gip_blur_route`'s kinds of launch.
WEIGHTED, FOLDED, BOX, BAND = range(4)
#: The device functions `gip_blur_route` answers with, by the code in its
#: answer's high byte; the low byte is a window kernel's template radius
#: (0: the radius at run time).
_FUNCTIONS = {1: "gauss_window_rows<Weighted, {}>",
              2: "gauss_window_rows<Folded, {}>",
              3: "gauss_window_rows<Box, {}>", 4: "box_window_rows",
              5: "box_wide_h + box_wide_v", 6: "band_mma_rows"}
_ROUTES: dict[tuple[int, int, int], str] = {}
#: Each launch function's `LAUNCHES` name and kind of launch.
_COUNTED = {"gip_gaussian_rows": ("gaussian_rows", WEIGHTED),
            "gip_gaussian_folded_rows": ("gaussian_folded_rows", FOLDED),
            "gip_gaussian_band_rows": ("gaussian_band_rows", BAND),
            "gip_box_window_rows": ("box_rows", BOX),
            "gip_box_wide_rows": ("box_rows", BOX),
            "gip_gaussian_planar": ("gaussian_planar", WEIGHTED),
            "gip_gaussian_folded_planar": ("gaussian_folded_planar", FOLDED),
            "gip_box_planar": ("box_planar", BOX)}


def route(lib: ctypes.CDLL, kind: int, radius: int, channels: int) -> str:
    """The device function that a launch of `kind` (`WEIGHTED`, `FOLDED`,
    `BOX`, `BAND`) at `radius` and `channels` runs, as `blur.cu`'s launch
    functions pick it (a planar launch is one at one channel); raises where
    they refuse the arguments."""
    key = (kind, radius, channels)
    name = _ROUTES.get(key)
    if name is None:
        code = lib.gip_blur_route(kind, radius, channels)
        if code < 0:
            raise ValueError(f"no blur kernel of kind {kind} takes r = "
                             f"{radius} at {channels} channels")
        name = _ROUTES[key] = _FUNCTIONS[code >> 8].format(code & 0xFF)
    return name


def _make_plan(fn_name: str, rows: torch.Tensor, radius: int,
               channels: int) -> plan.Plan:
    lib = library(rows.device)
    name, kind = _COUNTED[fn_name]
    return plan.Plan(lib, fn_name, name, route(lib, kind, radius, channels),
                     rows.get_device())


def plan_for(fn_name: str, rows: torch.Tensor, radius: int,
             channels: int) -> plan.Plan:
    """The plan of a launch of `fn_name` at `radius` and `channels` on
    `rows`' card, counted by its wrapper's name and by the device function
    it runs (a planar launch is one at one channel)."""
    return plan.get((fn_name, radius, channels, rows.get_device()),
                    _make_plan, fn_name, rows, radius, channels)


def _launch(fn_name: str, rows: torch.Tensor, channels: int, radius: int,
            *tables_or_scale, scratch: bool = False,
            taps: torch.Tensor | None = None) -> torch.Tensor:
    """Launch one of blur.cu's functions on `rows`: input, scratch of the
    image's size (if `scratch`), output, its weight tables (or the box's
    scale; first, `taps` as a host array), then radius, batch, height,
    width, channels; and count the launch."""
    with spans.span("ops.launch"):
        batch, height, width = check_rows(rows, channels)
        if radius < 1:
            raise ValueError(f"radius must be >= 1; got {radius}")
        p = plan_for(fn_name, rows, radius, channels)
        if taps is not None:
            tables_or_scale = (p.host_taps(taps), *tables_or_scale)
        out = torch.empty_like(rows)
        buffers = [rows.data_ptr(), out.data_ptr()]
        if scratch:
            buffers.insert(1, torch.empty_like(rows).data_ptr())
        p.launch(*buffers, *tables_or_scale, radius, batch, height, width,
                 channels)
        return out


def _launch_gaussian(fn_name: str, rows: torch.Tensor, weights: torch.Tensor,
                     radius: int, channels: int) -> torch.Tensor:
    check_table(weights, rows, radius, "weights", on_host=True)
    if radius > GAUSS_MAX_RADIUS or channels > GAUSS_MAX_CHANNELS:
        raise ValueError(f"the gaussian kernel takes r <= {GAUSS_MAX_RADIUS} "
                         f"and at most {GAUSS_MAX_CHANNELS} channels; got "
                         f"r = {radius}, {channels} channels")
    return _launch(fn_name, rows, channels, radius, taps=weights)


def gaussian_rows(rows: torch.Tensor, weights: torch.Tensor, radius: int,
                  channels: int) -> torch.Tensor:
    """Separable gaussian blur, level-2 numerics (taps in order).

    `weights` is the (2r+1,) float32 table, on the host or on `rows`'
    device.  The kernel takes its values by value, as launch parameters: a
    table on the card is read back first, which waits for the card, so a
    caller that launches often passes it on the host.
    """
    if rows.is_cpu:
        return gaussian_rows_plain(rows, weights, radius, channels)
    return _launch_gaussian("gip_gaussian_rows", rows, weights, radius,
                            channels)


def gaussian_folded_rows(rows: torch.Tensor, weights: torch.Tensor,
                         radius: int, channels: int) -> torch.Tensor:
    """Separable gaussian blur with symmetric tap pairs (level 4, r < 3);
    `weights` as in `gaussian_rows`."""
    if rows.is_cpu:
        return gaussian_folded_rows_plain(rows, weights, radius, channels)
    return _launch_gaussian("gip_gaussian_folded_rows", rows, weights, radius,
                            channels)


def gaussian_band_rows(rows: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                       radius: int, channels: int) -> torch.Tensor:
    """Separable gaussian blur with bf16 hi + lo weights (level 4, r >= 3),
    1 <= r <= `BAND_MAX_RADIUS`.

    `hi`, `lo` are the f32 tables of `ops.weights.bf16_split`, on the same
    device as `rows`.
    """
    if rows.is_cpu:
        return gaussian_band_rows_plain(rows, hi, lo, radius, channels)
    check_table(hi, rows, radius, "hi")
    check_table(lo, rows, radius, "lo")
    if radius > BAND_MAX_RADIUS or channels > BAND_MAX_CHANNELS:
        raise ValueError(f"the band kernel takes r <= {BAND_MAX_RADIUS} and "
                         f"at most {BAND_MAX_CHANNELS} channels; got r = "
                         f"{radius}, {channels} channels")
    return _launch("gip_gaussian_band_rows", rows, channels, radius,
                   hi.data_ptr(), lo.data_ptr())


@functools.lru_cache(maxsize=256)
def box_scale(radius: int) -> float:
    """The box's f32 reciprocal 1/(2r+1), as the float its launch takes."""
    return float(box_inv_taps_f32(radius))


def box_rows(rows: torch.Tensor, radius: int, channels: int) -> torch.Tensor:
    """Separable box blur, any radius >= 1, exact at levels 2 and 4; on the
    card, at most `BOX_MAX_CHANNELS` channels."""
    if rows.is_cpu:
        return box_rows_plain(rows, radius, channels)
    if channels > BOX_MAX_CHANNELS:
        raise ValueError(f"box_rows takes at most {BOX_MAX_CHANNELS} "
                         f"channels on the card; got {channels}")
    inv = box_scale(radius)
    if radius <= BOX_WINDOW_MAX_RADIUS:
        return _launch("gip_box_window_rows", rows, channels, radius, inv)
    return _launch("gip_box_wide_rows", rows, channels, radius, inv,
                   scratch=True)
