"""The causal VAE's counted work in one request: every convolution (2 Ci
Co kt kh kw operations an output position), the 1x1x1 widening of each
upsampler, and the mid blocks' attention (its four linears and 4 S^2 C a
frame), walked from the configuration, untiled or over the benchmark's
own copy of the uniform tile grid. All bf16 (the VAE's served type)."""

from typing import List

from ..reference import geometry
from .work import Work


def _conv(ci, co, k, t, h, w) -> Work:
    pos = t * h * w
    kk = k[0] * k[1] * k[2]
    return Work("vae", "conv", 2.0 * ci * co * kk * pos,
                2.0 * (ci * pos + co * ci * kk + co * pos), "bf16", None)


def _resnet(out, ci, co, kt2, t, h, w):
    out.append(_conv(ci, co, (3, 3, 3), t, h, w))
    out.append(_conv(co, co, (kt2, 3, 3), t, h, w))
    if ci != co:
        out.append(_conv(ci, co, (1, 1, 1), t, h, w))


def _mid(out, vae, c, kt2, t, h, w):
    _resnet(out, c, c, kt2, t, h, w)
    if vae["mid_attention"]:
        s = h * w
        out.append(Work("vae", "attention",
                        t * (4 * 2.0 * s * c * c + 4.0 * s * s * c),
                        t * 2.0 * (2 * s * c + 4 * c * c), "bf16", None))
    _resnet(out, c, c, kt2, t, h, w)


def encode(vae: dict, t: int, h: int, w: int) -> List[Work]:
    """An encode of (t, h, w) frames (t % 4 == 1, h, w multiples of 8)."""
    chans, n = vae["block_out_channels"], len(vae["block_out_channels"])
    kt2 = 1 if vae["time_receptive_field"] == "half" else 3
    out = [_conv(vae["in_channels"], chans[0], (3, 3, 3), t, h, w)]
    ci = chans[0]
    for i, co in enumerate(chans):
        for j in range(vae["layers_per_block"]):
            _resnet(out, ci if j == 0 else co, co, kt2, t, h, w)
        if i < n - 1:
            temporal = i >= n - vae["temporal_scale_num"] - 1
            t = (t - 1) // 2 + 1 if temporal else t
            h, w = h // 2, w // 2
            out.append(_conv(co, co, (3 if temporal else 1, 3, 3), t, h, w))
        ci = co
    _mid(out, vae, chans[-1], kt2, t, h, w)
    out.append(_conv(chans[-1], 2 * vae["latent_channels"], (3, 3, 3), t, h,
                     w))
    return out


def decode(vae: dict, t: int, h: int, w: int) -> List[Work]:
    """A decode of a (t, h, w) latent."""
    rev = list(reversed(vae["block_out_channels"]))
    kt2 = 1 if vae["time_receptive_field"] == "half" else 3
    out = [_conv(vae["latent_channels"], rev[0], (3, 3, 3), t, h, w)]
    _mid(out, vae, rev[0], kt2, t, h, w)
    ci = rev[0]
    for i, co in enumerate(rev):
        for j in range(vae["layers_per_block"] + 1):
            _resnet(out, ci if j == 0 else co, co, kt2, t, h, w)
        if i < len(rev) - 1:
            temporal = i < vae["temporal_scale_num"]
            tr = 2 if temporal else 1
            out.append(_conv(co, co * 4 * tr, (1, 1, 1), t, h, w))
            t, h, w = (2 * t - 1 if temporal else t), 2 * h, 2 * w
            out.append(_conv(co, co, (3, 3, 3), t, h, w))
        ci = co
    out.append(_conv(rev[-1], vae["out_channels"], (3, 3, 3), t, h, w))
    return out


def _tiles(h, w, tile, overlap, sf, cost):
    lt = (max(1, tile[0] // sf), max(1, tile[1] // sf))
    lo = (max(0, min(overlap[0] // sf, lt[0] - 1)),
          max(0, min(overlap[1] // sf, lt[1] - 1)))
    ys, th, xs, tw = geometry.plan_grid(h, w, lt[0] * lt[1], lo[0], lo[1],
                                        cost)
    return [(min(y + th, h) - y, min(x + tw, w) - x) for y in ys for x in xs]


def request(vae: dict, tiling: dict, t: int, hp: int, wp: int) -> List[Work]:
    """Encode and decode of one request's padded (t, hp, wp) frames under
    the lane's tiling (uniform grid; a frame within one tile is whole)."""
    sf = vae["spatial_downsample_factor"]
    hl, wl = hp // sf, wp // sf
    tl = (t - 1) // vae["temporal_downsample_factor"] + 1
    out: List[Work] = []
    tile = tiling["encode_tile_size"]
    if tiling["encode_tiled"] and not (hp <= tile[0] and wp <= tile[1]):
        for th, tw in _tiles(hl, wl, tile, tiling["encode_tile_overlap"], sf,
                             "area"):
            out += encode(vae, t, th * sf, tw * sf)
    else:
        out += encode(vae, t, hp, wp)
    tile = tiling["decode_tile_size"]
    lt = (max(1, tile[0] // sf), max(1, tile[1] // sf))
    if tiling["decode_tiled"] and not (hl <= lt[0] and wl <= lt[1]):
        for th, tw in _tiles(hl, wl, tile, tiling["decode_tile_overlap"], sf,
                             "aspect"):
            out += decode(vae, tl, th, tw)
    else:
        out += decode(vae, tl, hl, wl)
    return out
