"""Row-sharded filtering: image rows split across the devices of a mesh,
halo rows copied between neighbours.  The port of the JAX package's
`parallel/spatial.py`.

Each shard holds a contiguous band of rows.  The horizontal pass needs no
neighbour, as the full width is local; the vertical pass needs `radius`
rows of each neighbour (1 for Sobel), which `exchange_halo_rows` copies to
the shard's device.  The global first and last shard replicate their own
edge row, as clamp-to-edge does on one device.

With `use_kernels=True` each shard exchanges the raw uint8 rows and launches
the same hand-written kernels as one device, in their halo modes: the
planar blur (K5) with `rows_prepadded=True` and the batched planar Sobel
(K6) with `rows_prepadded=True, zero_rows=False`, one launch a shard.  The
horizontal pass is row-local and deterministic, so recomputing it on the
halo rows gives exactly what the neighbour computed, and the sharded result
equals one device's bit for bit.  On CPU tensors the kernels' wrappers
serve their plain versions.  `use_kernels=False` runs the plain bodies:
horizontal pass, quantize, exchange, vertical pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import api as cuda_api
from ..ops.cuda.blur_planar import box_planar, gaussian_planar
from ..ops.interleaved import (
    _summed,
    _tap_cols,
    _tap_rows,
    _weighted,
    grayscale,
    sobel_magnitude,
)
from ..ops.rounding import quantize_u8, quantize_u8_f32
from ..ops.weights import box_inv_taps_f32
from .mesh import Mesh

Blocks = list[list[torch.Tensor]]   # [dp][sp] blocks, each on its device


def exchange_halo_rows(x: torch.Tensor, before: torch.Tensor | None,
                       after: torch.Tensor | None, radius: int,
                       axis: int = -2) -> torch.Tensor:
    """`x` with `radius` halo rows on each side along `axis`, on x's device.

    `before` and `after` are the blocks of the shards before and after this
    one on the sp axis (None at the global first or last shard, which
    replicates its own edge row instead).  Their rows are copied to x's
    device.
    """
    hl = x.shape[axis]
    if before is None:
        top = x.narrow(axis, 0, 1).expand_as(x.narrow(axis, 0, radius))
    else:
        top = before.narrow(axis, before.shape[axis] - radius, radius).to(x.device)
    if after is None:
        bot = x.narrow(axis, hl - 1, 1).expand_as(x.narrow(axis, 0, radius))
    else:
        bot = after.narrow(axis, 0, radius).to(x.device)
    return torch.cat([top, x, bot], dim=axis)


def _exchange(stage: list[torch.Tensor], j: int, radius: int,
              axis: int = -2) -> torch.Tensor:
    """Shard j of one sp row of blocks, with its halo rows."""
    return exchange_halo_rows(stage[j], stage[j - 1] if j > 0 else None,
                              stage[j + 1] if j + 1 < len(stage) else None,
                              radius, axis)


def _zero_global_border_rows(out: torch.Tensor, index: int,
                             sp: int) -> torch.Tensor:
    """Zero the rows of shard `index`'s (B, Hl, W, C) block whose global
    index is 0 or sp*Hl - 1 (image_filters.cu:1164).  Width borders are
    zeroed within each shard (W is local)."""
    if index == 0:
        out[:, 0] = 0
    if index == sp - 1:
        out[:, -1] = 0
    return out


# ---------------------------------------------------------------------------
# Bodies.  Each is two stages around the halo exchange: `pre` makes what the
# shards exchange (raw planes, or the quantized horizontal pass), `post` runs
# the rest on the block with its halo rows.
# ---------------------------------------------------------------------------


def _gaussian_body(weights: torch.Tensor, radius: int, use_kernels: bool):
    if use_kernels:
        def pre(local):   # (b, Hl, W, C) -> (b*C, Hl, W) planes
            return cuda_api.to_planes(local).flatten(0, 1)

        def post(ext, local):
            out = gaussian_planar(ext, weights, radius, rows_prepadded=True)
            return cuda_api.from_planes(out.view(local.shape[0], -1,
                                                 *out.shape[-2:]))
        return pre, post, -2

    def pre(local):   # (b, C, Hl, W) f32, horizontal pass quantized
        w = weights.to(local.device)
        x = cuda_api.to_planes(local).to(torch.float32)
        return quantize_u8_f32(_weighted(_tap_cols(x, radius, 1), w))

    def post(ext, local):
        w = weights.to(local.device)
        v = quantize_u8(_weighted(_tap_rows(ext, radius, True), w))
        return cuda_api.from_planes(v)
    return pre, post, -2


def _box_body(radius: int, use_kernels: bool):
    if use_kernels:
        def pre(local):
            return cuda_api.to_planes(local).flatten(0, 1)

        def post(ext, local):
            out = box_planar(ext, radius, rows_prepadded=True)
            return cuda_api.from_planes(out.view(local.shape[0], -1,
                                                 *out.shape[-2:]))
        return pre, post, -2

    inv = float(box_inv_taps_f32(radius))

    def pre(local):
        x = cuda_api.to_planes(local).to(torch.float32)
        return quantize_u8_f32(_summed(_tap_cols(x, radius, 1)) * inv)

    def post(ext, local):
        return cuda_api.from_planes(
            quantize_u8(_summed(_tap_rows(ext, radius, True)) * inv))
    return pre, post, -2


def _sobel_body(level: int, use_kernels: bool):
    if use_kernels:
        def pre(local):   # raw (b, Hl, W, C) rows, exchanged on H
            return local

        def post(ext, local):
            return cuda_api.sobel_planar_batch(ext, level, rows_prepadded=True,
                                               zero_rows=False)
        return pre, post, -3

    def pre(local):   # (b, Hl, W) f32 grey
        gray = grayscale(local.to(torch.float32), -1)
        return quantize_u8_f32(gray) if level == 2 else gray

    def post(ext, local):
        edge = sobel_magnitude(ext, rows_prepadded=True, zero_rows=False)
        return edge[..., None].expand(local.shape).contiguous()
    return pre, post, -2


# ---------------------------------------------------------------------------
# Public builders
# ---------------------------------------------------------------------------


def spatial_halo(filter_name: str, radius: int) -> int:
    """Halo rows each shard needs from its neighbour (sobel: 1; blurs: r)."""
    return 1 if filter_name == "sobel" else radius


def spatial_h_target(h: int, sp: int, filter_name: str, radius: int) -> int:
    """The sp-divisible padded height `make_sharded_filter` computes, with
    at least `spatial_halo` rows a shard.  Callers that pad on the host
    (runtime/dispatch.py's row-sharded serving) use the same formula."""
    return sp * max(-(-h // sp), spatial_halo(filter_name, radius))


def edge_pad(x: torch.Tensor, pad_b: int, pad_h: int) -> torch.Tensor:
    """(B, H, ...) -> (B + pad_b, H + pad_h, ...), the last image and the
    last row replicated."""
    if pad_b:
        idx = torch.arange(x.shape[0] + pad_b, device=x.device)
        x = x.index_select(0, idx.clamp(max=x.shape[0] - 1))
    if pad_h:
        idx = torch.arange(x.shape[1] + pad_h, device=x.device)
        x = x.index_select(1, idx.clamp(max=x.shape[1] - 1))
    return x


class ShardedFilter:
    """The (dp, sp)-sharded filter that `make_sharded_filter` builds.

    Calling it runs the three steps a caller may also run apart (as the
    runtime does, to time only the device work): `shard` (pad and place the
    blocks on their devices), `step` (the filter, halo copies included) and
    `gather`.
    """

    def __init__(self, mesh: Mesh, filter_name: str, radius: int, level: int,
                 use_kernels: bool):
        if filter_name not in ("gaussian", "box", "sobel"):
            raise ValueError(f"Unknown filter: {filter_name}")
        self.mesh = mesh
        self.filter_name = filter_name
        self.radius = radius
        self.level = level
        self.use_kernels = use_kernels
        self.dp, self.sp = mesh.shape["dp"], mesh.shape["sp"]

    def shard(self, batch) -> Blocks:
        """A (B, H, W, C) uint8 array or tensor, edge-padded to B % dp == 0
        and `spatial_h_target` rows, as dp x sp contiguous blocks, each on
        its mesh device."""
        x = (batch if torch.is_tensor(batch)
             else torch.from_numpy(np.require(batch, requirements=["C", "W"])))
        if x.dtype != torch.uint8 or x.dim() != 4:
            raise ValueError(f"expected a (B, H, W, C) uint8 batch; got "
                             f"{x.dtype} {tuple(x.shape)}")
        b, h = x.shape[:2]
        h_target = spatial_h_target(h, self.sp, self.filter_name, self.radius)
        x = edge_pad(x, -b % self.dp, h_target - h)
        bl, hl = x.shape[0] // self.dp, h_target // self.sp
        return [[x[i * bl:(i + 1) * bl, j * hl:(j + 1) * hl]
                 .to(self.mesh.devices[i, j]).contiguous()
                 for j in range(self.sp)] for i in range(self.dp)]

    def step(self, blocks: Blocks, weights=None) -> Blocks:
        """The filtered blocks, each on its device.  Gaussian takes its
        (2r+1,) float32 table (numpy or tensor), the same for every
        shard."""
        r = self.radius
        if self.filter_name == "gaussian":
            if weights is None:
                raise ValueError("the sharded gaussian takes its weight table")
            pre, post, axis = _gaussian_body(cuda_api.table(weights), r,
                                             self.use_kernels)
        elif self.filter_name == "box":
            pre, post, axis = _box_body(r, self.use_kernels)
        else:
            r = 1
            pre, post, axis = _sobel_body(self.level, self.use_kernels)
        out = []
        for row in blocks:
            stage = [pre(local) for local in row]
            done = [post(_exchange(stage, j, r, axis), local)
                    for j, local in enumerate(row)]
            if self.filter_name == "sobel":
                done = [_zero_global_border_rows(o, j, self.sp)
                        for j, o in enumerate(done)]
            out.append(done)
        return out

    def gather(self, blocks: Blocks,
               device: torch.device | None = None) -> torch.Tensor:
        """The padded (B', H', W, C) result on `device` (default: the
        mesh's first device)."""
        device = self.mesh.devices[0, 0] if device is None else device
        return torch.cat([torch.cat([blk.to(device) for blk in row], dim=1)
                          for row in blocks], dim=0)

    def __call__(self, batch, weights=None) -> torch.Tensor:
        """(B, H, W, C) uint8 -> the filtered (B, H, W, C) uint8 tensor on
        the mesh's first device."""
        b, h = batch.shape[:2]
        out = self.gather(self.step(self.shard(batch), weights))
        padded_h = out.shape[1] != h
        if out.shape[:2] != (b, h):
            out = out[:b, :h].contiguous()
        if self.filter_name == "sobel" and padded_h:
            # The shards zeroed the padded bottom row; the true bottom
            # border row is zeroed here.
            out[:, h - 1] = 0
        return out


def make_sharded_filter(mesh: Mesh, filter_name: str, radius: int = 3,
                        level: int = 2, use_kernels: bool = True
                        ) -> ShardedFilter:
    """The (dp, sp)-sharded batch filter: B over dp, H over sp.

    Input: any (B, H, W, C) uint8 array or tensor; gaussian also takes its
    (2r+1,) float32 table.  Shapes that do not tile the mesh (B % dp != 0,
    H % sp != 0, or fewer than the halo rows a shard) are edge-padded,
    filtered and cropped: edge padding replicates the clamp row, so every
    tap an output row reads from the pad holds what clamp-to-edge gives,
    and the result stays bit-exact.  Sobel's true bottom border row is
    zeroed again after the crop.  `use_kernels` is the JAX `use_pallas`.
    """
    return ShardedFilter(mesh, filter_name, radius, level, use_kernels)
