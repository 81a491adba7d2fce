"""Plain causal video VAE (SeedVR2's s8_c16_t4 "attn_video_vae") in
float32: encode to the latent's mode, decode back to frames, untiled or over
the uniform tile grid with cosine fades.

Written from the published architecture for this benchmark's reference:
causal 3-D convolutions (the first frame repeated in front of the clip),
group norms with statistics per frame, SiLU, resnet blocks with 1x1x1
shortcuts, a spatial single-head attention per frame in the mid blocks,
strided downsamplers (temporal stride 2 in the last two), and upsamplers
that widen the channels by a 1x1x1 convolution and shuffle them into 2x2
pixels (and 2 frames, the duplicate of the first frame dropped). The whole
clip is one causal pass: the program's temporal slicing carries each
convolution's tail between slices, which computes the same.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry
from .params import StateParams as Params


def _conv(p: Params, key: str, x: torch.Tensor, stride=(1, 1, 1),
          t_pad: int = 0, s_pad=((1, 1), (1, 1))) -> torch.Tensor:
    """Causal conv over x (1, C, T, H, W): 2 * t_pad copies of the first
    frame in front, the spatial pads as given."""
    if t_pad > 0:
        x = torch.cat([x[:, :, :1].expand(-1, -1, 2 * t_pad, -1, -1), x], 2)
    (h0, h1), (w0, w1) = s_pad
    if h0 or h1 or w0 or w1:
        x = F.pad(x, (w0, w1, h0, h1))
    return F.conv3d(x, p(f"{key}.weight"), p(f"{key}.bias"), stride)


def _norm(p: Params, key: str, x: torch.Tensor, groups: int,
          eps: float = 1e-6) -> torch.Tensor:
    """Group norm with statistics per (group, frame)."""
    b, c, t, h, w = x.shape
    xr = x.reshape(b, groups, c // groups, t, h * w)
    var, mean = torch.var_mean(xr, dim=(2, 4), keepdim=True, correction=0)
    y = (xr - mean) * torch.rsqrt(var + eps)
    y = y.reshape(b, c, t, h, w)
    return (y * p(f"{key}.weight").view(1, c, 1, 1, 1)
            + p(f"{key}.bias").view(1, c, 1, 1, 1))


def _norm_silu_conv(p, norm, conv, x, groups):
    kt = p(f"{conv}.weight").shape[2]
    h = F.silu(_norm(p, norm, x, groups))
    return _conv(p, conv, h, t_pad=(kt - 1) // 2)


def _resnet(p: Params, key: str, x: torch.Tensor, groups: int):
    h = _norm_silu_conv(p, f"{key}.norm1", f"{key}.conv1", x, groups)
    h = _norm_silu_conv(p, f"{key}.norm2", f"{key}.conv2", h, groups)
    if f"{key}.conv_shortcut.weight" in p.keys:
        x = _conv(p, f"{key}.conv_shortcut", x, s_pad=((0, 0), (0, 0)))
    return x + h


_ATTN_Q = 4096  # query rows per softmax chunk


def _attention(p: Params, key: str, x: torch.Tensor, groups: int):
    """Per-frame single-head spatial attention with a residual."""
    b, c, t, h, w = x.shape
    hid = _norm(p, f"{key}.group_norm", x, groups)
    hid = hid.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)

    def lin(name, z):
        return z @ p(f"{key}.{name}.weight").t() + p(f"{key}.{name}.bias")

    q, k, v = lin("to_q", hid), lin("to_k", hid), lin("to_v", hid)
    out = torch.empty_like(q)
    for s in range(0, q.shape[1], _ATTN_Q):
        logits = (q[:, s:s + _ATTN_Q] @ k.transpose(1, 2)) * c ** -0.5
        out[:, s:s + _ATTN_Q] = torch.softmax(logits, dim=-1) @ v
    out = lin("to_out.0", out)
    return out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3) + x


def _mid(p, key, x, groups, attention: bool):
    x = _resnet(p, f"{key}.resnets.0", x, groups)
    if attention:
        x = _attention(p, f"{key}.attentions.0", x, groups)
    return _resnet(p, f"{key}.resnets.1", x, groups)


def encode(vae: dict, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (T, H, W, 3) in [-1, 1], T % 4 == 1 -> latent mode (Tl, H/8, W/8,
    latent_channels)."""
    g, chans = vae["norm_num_groups"], vae["block_out_channels"]
    n = len(chans)
    h = _conv(p, "encoder.conv_in", x.permute(3, 0, 1, 2)[None], t_pad=1)
    for i in range(n):
        base = f"encoder.down_blocks.{i}"
        for j in range(vae["layers_per_block"]):
            h = _resnet(p, f"{base}.resnets.{j}", h, g)
        if i < n - 1:
            temporal = i >= n - vae["temporal_scale_num"] - 1
            h = _conv(p, f"{base}.downsamplers.0.conv", h,
                      stride=(2 if temporal else 1, 2, 2),
                      t_pad=1 if temporal else 0, s_pad=((0, 1), (0, 1)))
    h = _mid(p, "encoder.mid_block", h, g, vae["mid_attention"])
    h = _norm_silu_conv(p, "encoder.conv_norm_out", "encoder.conv_out", h, g)
    if vae["use_quant_conv"]:
        h = _conv(p, "quant_conv", h, s_pad=((0, 0), (0, 0)))
    return h[0, :vae["latent_channels"]].permute(1, 2, 3, 0)


def _upsample(p: Params, key: str, x: torch.Tensor, temporal: bool):
    """1x1x1 widening conv, then channels (xi, yi, z, c) shuffled into rows,
    columns and frames; a temporal upsample drops the first frame's
    duplicate."""
    b, ci, t, h, w = x.shape
    tr = 2 if temporal else 1
    y = _conv(p, f"{key}.upscale_conv", x, s_pad=((0, 0), (0, 0)))
    c = y.shape[1] // (4 * tr)
    y = y.view(b, 2, 2, tr, c, t, h, w).permute(0, 4, 5, 3, 6, 1, 7, 2)
    y = y.reshape(b, c, t * tr, 2 * h, 2 * w)
    if temporal:
        y = torch.cat([y[:, :, :1], y[:, :, 2:]], dim=2)
    return _conv(p, f"{key}.conv", y, t_pad=1)


def decode(vae: dict, p: Params, z: torch.Tensor) -> torch.Tensor:
    """z (Tl, h, w, latent_channels) -> frames (4 (Tl - 1) + 1, 8h, 8w, 3)."""
    g = vae["norm_num_groups"]
    rev = list(reversed(vae["block_out_channels"]))
    x = z.permute(3, 0, 1, 2)[None]
    if vae["use_post_quant_conv"]:
        x = _conv(p, "post_quant_conv", x, s_pad=((0, 0), (0, 0)))
    x = _conv(p, "decoder.conv_in", x, t_pad=1)
    x = _mid(p, "decoder.mid_block", x, g, vae["mid_attention"])
    for i in range(len(rev)):
        base = f"decoder.up_blocks.{i}"
        for j in range(vae["layers_per_block"] + 1):
            x = _resnet(p, f"{base}.resnets.{j}", x, g)
        if i < len(rev) - 1:
            x = _upsample(p, f"{base}.upsamplers.0", x,
                          i < vae["temporal_scale_num"])
    x = _norm_silu_conv(p, "decoder.conv_norm_out", "decoder.conv_out", x, g)
    return x[0].permute(1, 2, 3, 0)


def _crops(total: int, starts, size):
    return [(s, min(s + size, total)) for s in starts]


def encode_tiled(vae: dict, p: Params, x: torch.Tensor, tile, overlap):
    """Encode over the uniform grid of latent tiles of area <= tile px
    (tile, overlap: (h, w) px), blended by cosine fades; a frame no larger
    than one tile is encoded whole."""
    T, H, W, _ = x.shape
    if H <= tile[0] and W <= tile[1]:
        return encode(vae, p, x)
    sf = vae["spatial_downsample_factor"]
    lt = (max(1, tile[0] // sf), max(1, tile[1] // sf))
    lo = (max(0, min(overlap[0] // sf, lt[0] - 1)),
          max(0, min(overlap[1] // sf, lt[1] - 1)))
    hl, wl = -(-H // sf), -(-W // sf)
    ys, th, xs, tw = geometry.plan_grid(hl, wl, lt[0] * lt[1], lo[0], lo[1])
    fh = min(lo[0], geometry.min_overlap(ys, th)) or lo[0]
    fw = min(lo[1], geometry.min_overlap(xs, tw)) or lo[1]
    acc = count = None
    for y, ye in _crops(hl, ys, th):
        for xx, xe in _crops(wl, xs, tw):
            lat = encode(vae, p, x[:, y * sf:min(ye * sf, H),
                                   xx * sf:min(xe * sf, W)])
            if acc is None:
                acc = torch.zeros((lat.shape[0], hl, wl, lat.shape[-1]),
                                  dtype=torch.float32, device=x.device)
                count = torch.zeros((hl, wl), dtype=torch.float32,
                                    device=x.device)
            eh, ew = min(ye - y, lat.shape[1]), min(xe - xx, lat.shape[2])
            m = torch.as_tensor(np.outer(
                geometry.fade(eh, fh, y > 0, ye < hl),
                geometry.fade(ew, fw, xx > 0, xe < wl)),
                dtype=torch.float32, device=x.device)
            acc[:, y:y + eh, xx:xx + ew] += lat[:, :eh, :ew] * m[..., None]
            count[y:y + eh, xx:xx + ew] += m
    return acc / count.clamp_min(1e-6)[..., None]


def decode_tiled(vae: dict, p: Params, z: torch.Tensor, tile, overlap):
    """Decode over the uniform grid of latent tiles (area <= tile px, the
    grid with least modelled decode time), blended in pixels by cosine
    fades of the pixel overlap; a latent no larger than one tile is
    decoded whole."""
    Tl, h, w, _ = z.shape
    sf = vae["spatial_downsample_factor"]
    lt = (max(1, tile[0] // sf), max(1, tile[1] // sf))
    if h <= lt[0] and w <= lt[1]:
        return decode(vae, p, z)
    lo = (max(0, min(overlap[0] // sf, lt[0] - 1)),
          max(0, min(overlap[1] // sf, lt[1] - 1)))
    ys, th, xs, tw = geometry.plan_grid(h, w, lt[0] * lt[1], lo[0], lo[1],
                                        cost="aspect")
    fh = min(overlap[0], geometry.min_overlap(ys, th) * sf) or overlap[0]
    fw = min(overlap[1], geometry.min_overlap(xs, tw) * sf) or overlap[1]
    acc = None
    count = torch.zeros((h * sf, w * sf), dtype=torch.float32,
                        device=z.device)
    for y, ye in _crops(h, ys, th):
        for xx, xe in _crops(w, xs, tw):
            m = torch.as_tensor(np.outer(
                geometry.fade((ye - y) * sf, fh, y > 0, ye < h),
                geometry.fade((xe - xx) * sf, fw, xx > 0, xe < w)),
                dtype=torch.float32, device=z.device)
            out = decode(vae, p, z[:, y:ye, xx:xe])
            if acc is None:
                acc = torch.zeros((out.shape[0], h * sf, w * sf, 3),
                                  dtype=torch.float32, device=z.device)
            acc[:, y * sf:ye * sf, xx * sf:xe * sf] += out * m[..., None]
            count[y * sf:ye * sf, xx * sf:xe * sf] += m
    return acc / count.clamp_min(1e-6)[..., None]
