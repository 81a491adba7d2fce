"""VideoVAE: temporal slicing and spatial tiling over the encoder/decoder
cores.

Port of seedvr2_tpu.models.vae.pipeline_vae:
 - temporal slicing: frame 0 plus 4-frame groups (latent: 2 then 1), with
   the causal-conv tail state threaded between slices;
 - spatial tiling, `tile_mode="uniform"`: an even grid of same-shape tiles
   (`_plan_grid`, host-side numpy copied from the JAX package and pinned
   equal by test) blended with separable cosine-ramp fades; each tile is
   encoded/decoded alone and accumulated into ONE fp32 output buffer, so
   peak memory is one tile's workspace plus the output;
 - `tile_mode="ref"`: the reference's stride sweep (`_plan_ref`, sliver
   edge tiles of other shapes included), blended the same way;
 - latent = posterior mode = the first `latent_channels` channels of the
   encoder moments (after the legacy family's quant_conv, when it has one).
Memory-probed tile sizes ("auto") are resolved by the runner
(core/runner.py, utils/memplan.py) before a call reaches this module.
Given a mesh (`mesh=`, the runner's when it tiles an item over the mesh)
the tiles of a tiled call go one a rank over every rank of the mesh, in
waves, each wave's tiles shared with every rank and blended in input order
(JAX's _tile_map, through parallel/comm.spread): the same sums in the same
order, so bit-equal to one rank.

Spans (utils/spans.py), named under the caller's (`decode.vae.plan` in the
pipeline's decode): `plan` the host's tile plan, fades and count, `tile`
each tile's call, `blend` each add into the blend buffer, `slice` each
temporal slice; the masks' and 1 / count's uploads count as h2d_bytes.

The VAE's opt-in lowerings are fixed at construction, as the JAX VideoVAE
snapshots its lowering switches: with `cfg.conv_quant == "int8"` the
decoder's resnet convs are quantized once to int8 (kernel K11's layout, as
non-persistent buffers, so checkpoints still load strictly under the
reference key names), and the environment's switches, read once here,
set the `Lowering`: SEEDVR2_FUSED_NORM=1 the fused norm+SiLU+head pass
(kernel K12), SEEDVR2_UPSAMPLE_CONVT=0 the matmul + pixel-shuffle
upsample, SEEDVR2_HEAD_CORRECTION=1 the causal head as a correction conv,
SEEDVR2_CONV_IM2COL=1 the im2col form of convs with K <= 128.

Layout is channels-last: video (B, T, H, W, 3) in [-1, 1], latent
(B, Tl, h, w, latent_channels).
"""

import math
import os
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...core.configs import VAEConfig
from ...ops.int8_conv import conv_weight_int8
from ...parallel.comm import agreed, spread
from ...utils import spans
from .model import Lowering, VideoAutoencoder, decoder_core, encoder_core


def _cos_ramp(n: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return 0.5 - 0.5 * np.cos(t * np.pi)


def _fade_weights(length: int, overlap: int, at_start: bool,
                  at_end: bool) -> np.ndarray:
    """Separable fade profile of one tile side."""
    wgt = np.ones((length,), dtype=np.float32)
    ov = max(0, min(overlap, length - 1))
    if ov > 0:
        ramp = _cos_ramp(overlap)[:ov]
        if at_start:
            wgt[:ov] = ramp
        if at_end:
            wgt[-ov:] = 1.0 - ramp
    return wgt


def _even_starts(total: int, tile: int, n: int):
    if n == 1:
        return [0]
    return [round(i * (total - tile) / (n - 1)) for i in range(n)]


def _min_overlap(starts, tile):
    if len(starts) < 2:
        return 0
    return min(starts[i] + tile - starts[i + 1]
               for i in range(len(starts) - 1))


def _tile_cost_aspect(n_tiles: int, th: int, tw: int) -> float:
    """The JAX package's fitted decode wall-time model of one uniform grid
    (per-tile time ~ th * tw * (th + 250) plus a fixed per-tile term). It
    was fitted on a TPU; the port keeps it so that both plan the same grids,
    and has not refitted it for the GPU."""
    return float(n_tiles) * (float(th) * tw * (th + 250) + 600_000.0)


def _plan_grid(h: int, w: int, cap_area: int, ov_h: int, ov_w: int,
               force_grid=None, cost: str = "area"):
    """Uniform tile-grid planning: evenly spaced SAME-SHAPE (th x tw) tiles
    covering h x w with th * tw <= cap_area and overlaps >= the requested
    minimums, minimizing total tile area (cost="area") or the fitted decode
    time model (cost="aspect"). force_grid=(nr, nc) plans exactly that grid.

    Returns (ys, th, xs, tw)."""
    if force_grid is not None:
        nr = max(1, min(int(force_grid[0]), h))
        nc = max(1, min(int(force_grid[1]), w))
        th = min(h, math.ceil((h + (nr - 1) * ov_h) / nr))
        tw = min(w, math.ceil((w + (nc - 1) * ov_w) / nc))
        return _even_starts(h, th, nr), th, _even_starts(w, tw, nc), tw
    best = None
    for nr in range(1, min(h, 64) + 1):
        th = min(h, math.ceil((h + (nr - 1) * ov_h) / nr))
        if nr > 1 and th <= ov_h:
            break
        # smallest nc whose tile width fits the area cap (larger nc only
        # increases total area for this nr)
        nc_found = None
        for nc in range(1, min(w, 64) + 1):
            tw = min(w, math.ceil((w + (nc - 1) * ov_w) / nc))
            if nc > 1 and tw <= ov_w:
                break
            if th * tw <= cap_area:
                nc_found = (nc, tw)
                break
        if nc_found is None:
            continue
        nc, tw = nc_found
        c = (_tile_cost_aspect(nr * nc, th, tw) if cost == "aspect"
             else float(nr * nc * th * tw))
        if best is None or c < best[0]:
            best = (c, nr, nc, th, tw)
    if best is None:  # cap smaller than any coverable tile: degenerate 1x1
        return [0], h, [0], w
    _, nr, nc, th, tw = best
    return _even_starts(h, th, nr), th, _even_starts(w, tw, nc), tw


TILE_MODES = ("uniform", "ref")


def _check_mode(tile_mode: str) -> None:
    if tile_mode not in TILE_MODES:
        raise ValueError(f"tile_mode must be one of {TILE_MODES}, got "
                         f"{tile_mode!r}")


def _plan_ref(h: int, w: int, lt_h: int, lt_w: int, lo_h: int, lo_w: int):
    """The reference's stride sweep over an h x w latent: tiles of at most
    lt_h x lt_w every (lt - lo), cut at the edge, an edge tile kept only if
    it reaches more than the overlap past its start. Returns
    [(y, y_end, x, x_end)]."""
    stride_h, stride_w = max(1, lt_h - lo_h), max(1, lt_w - lo_w)
    rows = [(y, min(y + lt_h, h)) for y in range(0, h, stride_h)
            if y == 0 or min(y + lt_h, h) - y > lo_h]
    cols = [(x, min(x + lt_w, w)) for x in range(0, w, stride_w)
            if x == 0 or min(x + lt_w, w) - x > lo_w]
    return [(y, y_end, x, x_end) for y, y_end in rows for x, x_end in cols]


@spans.span("slice")
def _slice(core, *args):
    """One temporal slice: encoder_core or decoder_core."""
    return core(*args)


def _encode_slices(vae: VideoAutoencoder, x: torch.Tensor,
                   lowering: Lowering = Lowering()) -> torch.Tensor:
    """Temporally sliced encode; returns the (un-truncated) moments. Tails
    are kept only for slices that have a successor."""
    T = x.shape[1]
    split = vae.cfg.slicing_sample_min_size
    if (T - 1) <= split:
        return _slice(encoder_core, vae, x, None, False, lowering)[0]
    outs = []
    moments, state = _slice(encoder_core, vae, x[:, : split + 1], None, True,
                            lowering)
    outs.append(moments)
    pos = split + 1
    while pos < T:
        last = pos + split >= T
        moments, state = _slice(encoder_core, vae, x[:, pos: pos + split],
                                state, not last, lowering)
        outs.append(moments)
        pos += split
    return torch.cat(outs, dim=1)


def _decode_slices(vae: VideoAutoencoder, z: torch.Tensor,
                   lowering: Lowering = Lowering()) -> torch.Tensor:
    """Temporally sliced decode (latent frame 0 + 1, then one at a time)."""
    Tl = z.shape[1]
    split = vae.cfg.slicing_latent_min_size
    if (Tl - 1) <= split:
        return _slice(decoder_core, vae, z, None, False, lowering)[0]
    outs = []
    out, state = _slice(decoder_core, vae, z[:, : split + 1], None, True,
                        lowering)
    outs.append(out)
    pos = split + 1
    while pos < Tl:
        last = pos + split >= Tl
        out, state = _slice(decoder_core, vae, z[:, pos: pos + split], state,
                            not last, lowering)
        outs.append(out)
        pos += split
    return torch.cat(outs, dim=1)


def _blend_buffer(shape, device) -> torch.Tensor:
    """The fp32 zeros a tiled call blends its tiles into."""
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _blend_tiles(tiles, steps, finish, mesh, device):
    """step(tile) for each step and the next tile of `tiles` in turn, then
    finish()'s result. Over a mesh, a failure here on one rank (in a step
    or in finish, an out-of-memory in the blend's temporaries above all) is
    agreed by every rank once every tile has been received (parallel.comm
    .agreed), so no rank leaves the tile waves early and every rank raises
    alike: a caller's OOM retry then runs on every rank with one plan."""
    err = None
    for step in steps:
        tile = next(tiles)
        if err is None:
            try:
                with spans.span("blend"):
                    step(tile)
            except Exception as e:  # noqa: BLE001 - re-raised once agreed
                err = e
        del tile

    def done():
        if err is not None:
            raise err
        return finish()

    return agreed(done, mesh, device, "tiled call")


def int8_served_convs(model: VideoAutoencoder):
    """(path, conv) of every conv the int8 path serves: the decoder's
    3-deep resnet convs (mid block and up blocks) whose channel dims are
    multiples of 128. The upsampler convs, conv_out, the 1x1 shortcuts and
    the legacy family's (1, 3, 3) conv2 stay bf16."""
    dec = model.decoder
    blocks = [("decoder.mid_block", dec.mid_block)] + [
        (f"decoder.up_blocks.{i}", b) for i, b in enumerate(dec.up_blocks)]
    for base, blk in blocks:
        for j, res in enumerate(blk.resnets):
            for name in ("conv1", "conv2"):
                conv = getattr(res, name)
                if (conv.weight.shape[2] == 3 and conv.in_channels % 128 == 0
                        and conv.out_channels % 128 == 0):
                    yield f"{base}.resnets.{j}.{name}", conv


class VideoVAE:
    """Encode/decode front end over a VideoAutoencoder's parameters."""

    def __init__(self, model: VideoAutoencoder, dtype=torch.bfloat16):
        self.model = model
        self.cfg: VAEConfig = model.cfg
        self.dtype = dtype
        # the JAX VideoVAE snapshots its lowering switches at construction,
        # with these defaults and string tests
        env = os.environ.get
        self.lowering = Lowering(
            fused_norm=env("SEEDVR2_FUSED_NORM", "0") == "1",
            upsample_convt=env("SEEDVR2_UPSAMPLE_CONVT", "1") == "1",
            head_correction=env("SEEDVR2_HEAD_CORRECTION", "0") == "1",
            im2col_max_k=128 if env("SEEDVR2_CONV_IM2COL", "0") == "1"
            else 0)
        if self.cfg.conv_quant == "int8":
            with torch.no_grad():
                for _, conv in int8_served_convs(model):
                    wk, ws = conv_weight_int8(conv.weight)
                    conv.register_buffer("wq", wk, persistent=False)
                    conv.register_buffer("ws", ws, persistent=False)
        # output-space (y, x, h, w) pixel rectangles of the last tiled call
        self.last_encode_tiles = []
        self.last_decode_tiles = []

    @staticmethod
    def _tile_map(run, crops, mesh):
        """run(crop) for each crop, yielded in input order; over a mesh of
        more than one rank the crops go one a rank in waves of the mesh's
        size (the VAE has no tensor parallelism: the dp and tp ranks all
        take tiles), each wave's results shared with every rank. A lone
        crop runs on every rank. Each run is the span `tile`."""
        def tile(crop):
            with spans.span("tile"):
                return run(crop)

        return spread(crops, tile, None if len(crops) == 1 else mesh, None,
                      crops[0].device)

    @torch.no_grad()
    def encode(self, x: torch.Tensor, tiled: bool = False,
               tile_size: Tuple[int, int] = (512, 512),
               tile_overlap: Tuple[int, int] = (64, 64),
               tile_mode: str = "uniform",
               tile_grid: Optional[Tuple[int, int]] = None,
               mesh=None) -> torch.Tensor:
        """x: (B, T, H, W, 3) in [-1, 1], T % 4 == 1 -> latent mode
        (B, (T-1)/4+1, H/8, W/8, latent_channels).

        tiled: with tile_mode "uniform" encode an even grid of same-shape
        tiles of at most tile_size px area (`_plan_grid`, or exactly
        tile_grid=(rows, cols)) overlapping by at least tile_overlap px;
        with "ref" the reference's stride sweep (`_plan_ref`); blended with
        cosine fades. A frame no larger than one tile is encoded untiled.
        mesh: a parallel.mesh.Mesh whose ranks share the tiles (every rank
        calls with the same arguments), None: every tile here."""
        x = x.to(self.dtype)
        B, T, H, W, _ = x.shape
        lat = self.cfg.latent_channels
        if not tiled or (H <= tile_size[0] and W <= tile_size[1]):
            return _encode_slices(self.model, x, self.lowering)[..., :lat]
        _check_mode(tile_mode)
        sf = self.cfg.spatial_downsample_factor
        lt_h = max(1, tile_size[0] // sf)
        lt_w = max(1, tile_size[1] // sf)
        lo_h = max(0, min(tile_overlap[0] // sf, lt_h - 1))
        lo_w = max(0, min(tile_overlap[1] // sf, lt_w - 1))
        H_lat = (H + sf - 1) // sf
        W_lat = (W + sf - 1) // sf
        Tl = (T - 1) // self.cfg.temporal_downsample_factor + 1

        with spans.span("plan"):
            if tile_mode == "ref":
                rects = _plan_ref(H_lat, W_lat, lt_h, lt_w, lo_h, lo_w)
                fade_h, fade_w = lo_h, lo_w
            else:
                ys, th, xs, tw = _plan_grid(H_lat, W_lat, lt_h * lt_w, lo_h,
                                            lo_w, force_grid=tile_grid)
                fade_h = min(lo_h, _min_overlap(ys, th)) or lo_h
                fade_w = min(lo_w, _min_overlap(xs, tw)) or lo_w
                rects = [(y, y + th, xx, xx + tw) for y in ys for xx in xs]
            self.last_encode_tiles = [
                (y * sf, xx * sf, (y_end - y) * sf, (x_end - xx) * sf)
                for (y, y_end, xx, x_end) in rects]
            count = np.zeros((H_lat, W_lat), np.float32)
            crops = [x[:, :, y * sf: min(y_end * sf, H),
                       xx * sf: min(x_end * sf, W)]
                     for (y, y_end, xx, x_end) in rects]

        # the blend buffer's allocation agreed before any tile is shared
        result = agreed(lambda: _blend_buffer((B, Tl, H_lat, W_lat, lat),
                                              x.device), mesh, x.device,
                        "tiled encode's blend buffer")
        # next() in the loop: a zip over the tiles would hold the last tile
        # while the next one encodes
        tiles = self._tile_map(
            lambda c: _encode_slices(self.model, c, self.lowering)[..., :lat],
            crops, mesh)

        def add(rect, tile):
            y, y_end, xx, x_end = rect
            tile = tile.float()
            eh = min(y_end - y, tile.shape[2], H_lat - y)
            ew = min(x_end - xx, tile.shape[3], W_lat - xx)
            mask = np.outer(_fade_weights(eh, fade_h, y > 0, y_end < H_lat),
                            _fade_weights(ew, fade_w, xx > 0, x_end < W_lat))
            result[:, :, y: y + eh, xx: xx + ew] += (
                tile[:, :Tl, :eh, :ew]
                * spans.to_device(mask, x.device)[None, None, :, :, None])
            count[y: y + eh, xx: xx + ew] += mask

        def finish():
            c = spans.to_device(np.clip(count, 1e-6, None), x.device)
            return (result / c[None, None, :, :, None]).to(self.dtype)

        return _blend_tiles(tiles, [partial(add, r) for r in rects], finish,
                            mesh, x.device)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, tiled: bool = False,
               tile_size: Tuple[int, int] = (512, 512),
               tile_overlap: Tuple[int, int] = (64, 64),
               tile_mode: str = "uniform",
               tile_grid: Optional[Tuple[int, int]] = None,
               mesh=None) -> torch.Tensor:
        """z: (B, Tl, h, w, latent) -> (B, (Tl-1)*4+1, 8h, 8w, 3).

        tiled: with tile_mode "uniform" decode an even grid of same-shape
        latent tiles (the area cap is tile_size px, planned by the fitted
        decode-time model, or exactly tile_grid), with "ref" the reference's
        stride sweep; fades in output space with the pixel overlap. The tiles
        are decoded one after another into one fp32 output buffer with
        host-built masks and 1 / count, as the JAX package's tiled-decode
        scan does. mesh: as encode's."""
        z = z.to(self.dtype)
        B, Tl, h, w, _ = z.shape
        sf = self.cfg.spatial_downsample_factor
        lt_h = max(1, tile_size[0] // sf)
        lt_w = max(1, tile_size[1] // sf)
        if not tiled or (h <= lt_h and w <= lt_w):
            return _decode_slices(self.model, z, self.lowering)
        _check_mode(tile_mode)
        lo_h = max(0, min(tile_overlap[0] // sf, lt_h - 1))
        lo_w = max(0, min(tile_overlap[1] // sf, lt_w - 1))
        T = (Tl - 1) * self.cfg.temporal_downsample_factor + 1
        H, W = h * sf, w * sf

        with spans.span("plan"):
            if tile_mode == "ref":
                rects = _plan_ref(h, w, lt_h, lt_w, lo_h, lo_w)
                fade_h, fade_w = tile_overlap
            else:
                ys, th, xs, tw = _plan_grid(h, w, lt_h * lt_w, lo_h, lo_w,
                                            force_grid=tile_grid,
                                            cost="aspect")
                fade_h = min(tile_overlap[0], _min_overlap(ys, th) * sf) \
                    or tile_overlap[0]
                fade_w = min(tile_overlap[1], _min_overlap(xs, tw) * sf) \
                    or tile_overlap[1]
                rects = [(y, y + th, xx, xx + tw) for y in ys for xx in xs]
            self.last_decode_tiles = [
                (y * sf, xx * sf, (y_end - y) * sf, (x_end - xx) * sf)
                for (y, y_end, xx, x_end) in rects]

            masks, count = [], np.zeros((H, W), np.float32)
            for (y, y_end, xx, x_end) in rects:
                m = np.outer(_fade_weights((y_end - y) * sf, fade_h, y > 0,
                                           y_end < h),
                             _fade_weights((x_end - xx) * sf, fade_w, xx > 0,
                                           x_end < w)).astype(np.float32)
                masks.append(m)
                count[y * sf: y_end * sf, xx * sf: x_end * sf] += m
            inv = 1.0 / np.clip(count, 1e-6, None)
        # the blend buffers' allocation agreed before any tile is shared
        result, inv_count = agreed(
            lambda: (_blend_buffer((B, T, H, W, 3), z.device),
                     spans.to_device(inv, z.device)),
            mesh, z.device, "tiled decode's blend buffers")
        tiles = self._tile_map(
            lambda c: _decode_slices(self.model, c, self.lowering),
            [z[:, :, y:y_end, xx:x_end] for (y, y_end, xx, x_end) in rects],
            mesh)

        def add(rect, m, tile):  # as in encode: no zip over the tiles
            y, y_end, xx, x_end = rect
            result[:, :, y * sf: y_end * sf, xx * sf: x_end * sf] += (
                tile.float()
                * spans.to_device(m, z.device)[None, None, :, :, None])

        return _blend_tiles(
            tiles, [partial(add, r, m) for r, m in zip(rects, masks)],
            lambda: (result * inv_count[None, None, :, :, None]).to(
                self.dtype), mesh, z.device)


@torch.no_grad()
def init_vae_params(cfg: VAEConfig, device, dtype=torch.bfloat16,
                    generator: Optional[torch.Generator] = None
                    ) -> VideoAutoencoder:
    """Random VAE drawn directly on `device` with the JAX package's
    init_vae_params distributions: conv and linear weights and biases
    U(+-1/sqrt(fan_in)), group norms weight 1 / bias 0; drawn in fp32 and
    rounded to `dtype`. The tree is `cfg`'s family: for the legacy one,
    (1, 3, 3) resnet conv2 ("half"), no mid attention and the 1x1x1 quant
    convs, as JAX's init_vae_params builds it."""
    with torch.device("meta"):
        model = VideoAutoencoder(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.Linear)):
            w = mod.weight
            bound = 1.0 / math.sqrt(w[0].numel())
            for p in (w, mod.bias):
                tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                p.copy_(tmp.uniform_(-bound, bound, generator=generator))
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
