"""VideoVAE: temporal slicing and uniform spatial tiling over the
encoder/decoder cores.

Port of seedvr2_tpu.models.vae.pipeline_vae:
 - temporal slicing: frame 0 plus 4-frame groups (latent: 2 then 1), with
   the causal-conv tail state threaded between slices;
 - spatial tiling, `tile_mode="uniform"`: an even grid of same-shape tiles
   (`_plan_grid`, host-side numpy copied from the JAX package and pinned
   equal by test) blended with separable cosine-ramp fades; each tile is
   encoded/decoded alone and accumulated into ONE fp32 output buffer, so
   peak memory is one tile's workspace plus the output;
 - latent = posterior mode = the first `latent_channels` channels of the
   encoder moments.
The reference stride-sweep layout (`tile_mode="ref"`) and memory-probed
tile sizes ("auto") are not ported yet.

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
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...core.configs import VAEConfig
from ...ops.int8_conv import conv_weight_int8
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


def _encode_slices(vae: VideoAutoencoder, x: torch.Tensor,
                   lowering: Lowering = Lowering()) -> torch.Tensor:
    """Temporally sliced encode; returns the (un-truncated) moments. Tails
    are kept only for slices that have a successor."""
    T = x.shape[1]
    split = vae.cfg.slicing_sample_min_size
    if (T - 1) <= split:
        return encoder_core(vae, x, None, False, lowering)[0]
    outs = []
    moments, state = encoder_core(vae, x[:, : split + 1], None, True,
                                  lowering)
    outs.append(moments)
    pos = split + 1
    while pos < T:
        last = pos + split >= T
        moments, state = encoder_core(vae, x[:, pos: pos + split], state,
                                      not last, lowering)
        outs.append(moments)
        pos += split
    return torch.cat(outs, dim=1)


def _decode_slices(vae: VideoAutoencoder, z: torch.Tensor,
                   lowering: Lowering = Lowering()) -> torch.Tensor:
    """Temporally sliced decode (latent frame 0 + 1, then one at a time)."""
    Tl = z.shape[1]
    split = vae.cfg.slicing_latent_min_size
    if (Tl - 1) <= split:
        return decoder_core(vae, z, None, False, lowering)[0]
    outs = []
    out, state = decoder_core(vae, z[:, : split + 1], None, True, lowering)
    outs.append(out)
    pos = split + 1
    while pos < Tl:
        last = pos + split >= Tl
        out, state = decoder_core(vae, z[:, pos: pos + split], state,
                                  not last, lowering)
        outs.append(out)
        pos += split
    return torch.cat(outs, dim=1)


def _check_mode(tile_mode: str) -> None:
    if tile_mode != "uniform":
        raise NotImplementedError(f"tile_mode={tile_mode!r} is not ported "
                                  "(uniform only)")


def int8_served_convs(model: VideoAutoencoder):
    """(path, conv) of every conv the int8 path serves: the decoder's
    resnet convs (mid block and up blocks) whose channel dims are
    multiples of 128. The upsampler convs, conv_out and the 1x1 shortcuts
    stay bf16."""
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

    @torch.no_grad()
    def encode(self, x: torch.Tensor, tiled: bool = False,
               tile_size: Tuple[int, int] = (512, 512),
               tile_overlap: Tuple[int, int] = (64, 64),
               tile_mode: str = "uniform",
               tile_grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """x: (B, T, H, W, 3) in [-1, 1], T % 4 == 1 -> latent mode
        (B, (T-1)/4+1, H/8, W/8, latent_channels).

        tiled: encode an even grid of same-shape tiles of at most
        tile_size px area (`_plan_grid`, or exactly tile_grid=(rows, cols))
        overlapping by at least tile_overlap px, blended with cosine fades.
        A frame no larger than one tile is encoded untiled."""
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

        ys, th, xs, tw = _plan_grid(H_lat, W_lat, lt_h * lt_w, lo_h, lo_w,
                                    force_grid=tile_grid)
        fade_h = min(lo_h, _min_overlap(ys, th)) or lo_h
        fade_w = min(lo_w, _min_overlap(xs, tw)) or lo_w
        rects = [(y, y + th, xx, xx + tw) for y in ys for xx in xs]
        self.last_encode_tiles = [
            (y * sf, xx * sf, (y_end - y) * sf, (x_end - xx) * sf)
            for (y, y_end, xx, x_end) in rects]

        result = torch.zeros((B, Tl, H_lat, W_lat, lat), dtype=torch.float32,
                             device=x.device)
        count = np.zeros((H_lat, W_lat), np.float32)
        for (y, y_end, xx, x_end) in rects:
            crop = x[:, :, y * sf: min(y_end * sf, H),
                     xx * sf: min(x_end * sf, W)]
            tile = _encode_slices(self.model, crop,
                                  self.lowering)[..., :lat].float()
            eh = min(y_end - y, tile.shape[2], H_lat - y)
            ew = min(x_end - xx, tile.shape[3], W_lat - xx)
            mask = np.outer(_fade_weights(eh, fade_h, y > 0, y_end < H_lat),
                            _fade_weights(ew, fade_w, xx > 0, x_end < W_lat))
            result[:, :, y: y + eh, xx: xx + ew] += (
                tile[:, :Tl, :eh, :ew]
                * torch.as_tensor(mask, device=x.device)[None, None, :, :,
                                                         None])
            count[y: y + eh, xx: xx + ew] += mask
        count = torch.as_tensor(np.clip(count, 1e-6, None), device=x.device)
        return (result / count[None, None, :, :, None]).to(self.dtype)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, tiled: bool = False,
               tile_size: Tuple[int, int] = (512, 512),
               tile_overlap: Tuple[int, int] = (64, 64),
               tile_mode: str = "uniform",
               tile_grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """z: (B, Tl, h, w, latent) -> (B, (Tl-1)*4+1, 8h, 8w, 3).

        tiled: decode an even grid of same-shape latent tiles (the area cap
        is tile_size px, planned by the fitted decode-time model, or exactly
        tile_grid), fades in output space with the pixel overlap. The tiles
        are decoded one after another into one fp32 output buffer with
        host-built masks and 1 / count, as the JAX package's tiled-decode
        scan does."""
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

        ys, th, xs, tw = _plan_grid(h, w, lt_h * lt_w, lo_h, lo_w,
                                    force_grid=tile_grid, cost="aspect")
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
        inv_count = torch.as_tensor(1.0 / np.clip(count, 1e-6, None),
                                    device=z.device)

        result = torch.zeros((B, T, H, W, 3), dtype=torch.float32,
                             device=z.device)
        for (y, y_end, xx, x_end), m in zip(rects, masks):
            tile = _decode_slices(self.model, z[:, :, y:y_end, xx:x_end],
                                  self.lowering)
            result[:, :, y * sf: y_end * sf, xx * sf: x_end * sf] += (
                tile.float()
                * torch.as_tensor(m, device=z.device)[None, None, :, :, None])
            del tile
        return (result * inv_count[None, None, :, :, None]).to(self.dtype)


@torch.no_grad()
def init_vae_params(cfg: VAEConfig, device, dtype=torch.bfloat16,
                    generator: Optional[torch.Generator] = None
                    ) -> VideoAutoencoder:
    """Random VAE drawn directly on `device` with the JAX package's
    init_vae_params distributions: conv and linear weights and biases
    U(+-1/sqrt(fan_in)), group norms weight 1 / bias 0; drawn in fp32 and
    rounded to `dtype`."""
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
