"""Plain NaDiT forward (the SeedVR2 3B and 7B denoisers) in float32.

Written from the published architecture for this benchmark's reference:
MM-DiT blocks over video and text tokens, AdaLN-single modulation from the
time embedding, qk RMS norms, 3-D rotary embeddings per window, windowed
attention that alternates plain and half-shifted 720p-normalised windows
(the text tokens join every window as keys and queries; their output is
the mean over the windows), and a SwiGLU (3B) or GELU-tanh (7B) MLP. Tokens
stay in raster order; each block gathers its windows by index.

`quant="w8a8"` computes the int8 serving lane's arithmetic from the same
float weights: every linear with min(K, N) >= 1024 and K, N multiples of
256 takes its weight per output channel and its input per row to
symmetric int8 (round half to even, clip to +-127), multiplies exactly and
scales back; `quant="w4a4"` does the same in int4 (+-7), the control of
the int8 lane. The block's weights are widened to float32 one block at a
time, so the reference fits beside the program's state on one card.
"""

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..weights import block_shared, block_vid_only
from . import geometry
from .params import StateParams as Params


# symmetric levels of each integer lane: int8, and int4 (the control's
# precision below it)
LEVELS = {"w8a8": 127, "w4a4": 7}


def _quantize_rows(x: torch.Tensor, levels: int):
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels), scale


def w8a8_converts(k: int, n: int) -> bool:
    """The int8 lane's rule for which linears it converts."""
    return min(k, n) >= 1024 and k % 256 == 0 and n % 256 == 0


def linear(p: Params, key: str, x: torch.Tensor, quant: str,
           bias: bool = True) -> torch.Tensor:
    if quant != "none" and quant not in LEVELS:
        raise ValueError(f"unknown lane {quant!r}")
    w = p(f"{key}.weight")
    n, k = w.shape
    if quant in LEVELS and w8a8_converts(k, n):
        wq, ws = _quantize_rows(w, LEVELS[quant])
        xq, xs = _quantize_rows(x, LEVELS[quant])
        out = (xq @ wq.t()) * xs * ws[:, 0]
    else:
        out = x @ w.t()
    return out + p(f"{key}.bias") if bias else out


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Interleaved-pair rotation of x's first cos.shape[-1] channels;
    x (..., S, H, D), tables (S, rot)."""
    rot = cos.shape[-1]
    xr = x[..., :rot]
    pairs = xr.reshape(*xr.shape[:-1], -1, 2)
    half = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).reshape(xr.shape)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([xr * c + half * s, x[..., rot:]], dim=-1)


def _time_embedding(p: Params, t: float, quant: str, device) -> torch.Tensor:
    half = 128
    freqs = torch.exp(-np.log(10000.0) * torch.arange(
        half, dtype=torch.float64, device=device) / half).float()
    arg = torch.tensor([t], dtype=torch.float32, device=device)[:, None] \
        * freqs[None]
    x = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    x = F.silu(linear(p, "emb_in.proj_in", x, quant))
    x = F.silu(linear(p, "emb_in.proj_hid", x, quant))
    return linear(p, "emb_in.proj_out", x, quant)[0]


def _mlp(p: Params, key: str, x: torch.Tensor, mlp_type: str, quant: str):
    if mlp_type == "swiglu":
        h = F.silu(linear(p, f"{key}.proj_in_gate", x, quant, bias=False)) \
            * linear(p, f"{key}.proj_in", x, quant, bias=False)
        return linear(p, f"{key}.proj_out", h, quant, bias=False)
    h = F.gelu(linear(p, f"{key}.proj_in", x, quant), approximate="tanh")
    return linear(p, f"{key}.proj_out", h, quant)


class _Windows:
    """One window method's groups on the device: token indices and the
    rotary tables of each window shape."""

    def __init__(self, dit: dict, grid, txt_len: int, shifted: bool, device):
        groups, self.count = geometry.window_groups(grid, dit["window"],
                                                    shifted)
        self.groups = []
        for shape, idx in groups:
            ang = geometry.video_angles(dit["rope_type"], shape, txt_len,
                                        dit["rope_dim"])
            self.groups.append((
                torch.as_tensor(idx, device=device),
                torch.as_tensor(np.cos(ang), dtype=torch.float32,
                                device=device),
                torch.as_tensor(np.sin(ang), dtype=torch.float32,
                                device=device)))


_ATTN_ROWS = 1 << 26  # query-key products per attention chunk


def _attention(dit: dict, p: Params, b: str, shared: bool, hv, ht,
               wins: _Windows, txt_cos, txt_sin, quant: str):
    """Joint windowed attention of one block: video (L, D), text (Lt, D) ->
    the projected video and text outputs. shared: the block's streams share
    one set of weights ("all"); the 3B's qk norms follow that, the 7B's
    never share."""
    H, Dh, eps = dit["heads"], dit["head_dim"], dit["norm_eps"]
    bv, bt = ("all", "all") if shared else ("vid", "txt")
    nq = "all" if shared and dit["family"] == "dit_3b" else None
    qkv_v = linear(p, f"{b}.attn.proj_qkv.{bv}", hv, quant,
                   dit["qk_bias"]).reshape(-1, 3, H, Dh)
    qkv_t = linear(p, f"{b}.attn.proj_qkv.{bt}", ht, quant,
                   dit["qk_bias"]).reshape(-1, 3, H, Dh)

    def norm(x, which, br):
        return rms_norm(x, eps) * p(f"{b}.attn.norm_{which}.{nq or br}.weight")

    qv, kv, vv = norm(qkv_v[:, 0], "q", "vid"), norm(qkv_v[:, 1], "k",
                                                      "vid"), qkv_v[:, 2]
    qt, kt, vt = norm(qkv_t[:, 0], "q", "txt"), norm(qkv_t[:, 1], "k",
                                                      "txt"), qkv_t[:, 2]
    if txt_cos is not None:
        qt, kt = _rotate(qt, txt_cos, txt_sin), _rotate(kt, txt_cos, txt_sin)
    L, Lt = hv.shape[0], ht.shape[0]
    out_v = torch.empty((L, H, Dh), dtype=torch.float32, device=hv.device)
    txt_sum = torch.zeros((Lt, H, Dh), dtype=torch.float32, device=hv.device)
    scale = Dh ** -0.5
    for idx, cos, sin in wins.groups:
        n, wlen = idx.shape
        s = wlen + Lt
        step = max(1, _ATTN_ROWS // (s * s * H))
        for a in range(0, n, step):
            ids = idx[a:a + step]
            m = ids.shape[0]

            def with_text(x_v, x_t, rope):
                w = x_v[ids]
                if rope:
                    w = _rotate(w, cos, sin)
                return torch.cat([w, x_t[None].expand(m, Lt, H, Dh)], dim=1)

            q = with_text(qv, qt, True).transpose(1, 2)
            k = with_text(kv, kt, True).transpose(1, 2)
            v = with_text(vv, vt, False).transpose(1, 2)
            probs = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
            o = (probs @ v).transpose(1, 2)           # (m, s, H, Dh)
            out_v[ids.reshape(-1)] = o[:, :wlen].reshape(-1, H, Dh)
            txt_sum += o[:, wlen:].sum(dim=0)
    txt_out = (txt_sum / wins.count).reshape(Lt, H * Dh)
    return (linear(p, f"{b}.attn.proj_out.{bv}", out_v.reshape(L, H * Dh),
                   quant),
            linear(p, f"{b}.attn.proj_out.{bt}", txt_out, quant))


def nadit(dit: dict, state: Dict[str, torch.Tensor], vid: torch.Tensor,
          txt: torch.Tensor, timestep: float, quant: str = "none"
          ) -> torch.Tensor:
    """The denoiser's velocity for one latent. vid (T, H, W, C_in) float32
    (noise | condition), txt (Lt, txt_in_dim); returns (T, H, W, C_out).

    state: the bf16 (or float) parameters by checkpoint key, widened to
    float32 as each layer reads them."""
    p = Params(state)
    D, eps = dit["vid_dim"], dit["norm_eps"]
    pt, ph, pw = dit["patch_size"]
    if pt != 1:
        raise ValueError("the reference patches space only (patch_size[0] 1)")
    T, Hh, Ww, C = vid.shape
    grid = (T, Hh // ph, Ww // pw)
    x = vid.reshape(T, grid[1], ph, grid[2], pw, C).permute(0, 1, 3, 2, 4, 5)
    x = linear(p, "vid_in.proj", x.reshape(-1, ph * pw * C), quant)
    xt = (linear(p, "txt_in", txt, quant) if "txt_in.weight" in state
          else txt)
    emb = _time_embedding(p, timestep, quant, vid.device).reshape(D, 2, 3)
    e_attn, e_mlp = emb[:, 0], emb[:, 1]            # (D, 3): shift, scale, gate
    Lt = txt.shape[0]
    wins = {s: _Windows(dit, grid, Lt, s, vid.device) for s in (False, True)}
    ang = geometry.text_angles(dit["rope_type"], Lt, dit["rope_dim"])
    txt_cos = txt_sin = None
    if ang is not None:
        txt_cos = torch.as_tensor(np.cos(ang), dtype=torch.float32,
                                  device=vid.device)
        txt_sin = torch.as_tensor(np.sin(ang), dtype=torch.float32,
                                  device=vid.device)

    def mod(h, e, ada, layer):
        return h * (e[:, 1] + p(f"{ada}.{layer}_scale")) + (
            e[:, 0] + p(f"{ada}.{layer}_shift"))

    def gate(h, e, ada, layer):
        return h * (e[:, 2] + p(f"{ada}.{layer}_gate"))

    for i in range(dit["num_layers"]):
        b = f"blocks.{i}"
        shared = block_shared(dit, i)
        ada_v = f"{b}.ada.{'all' if shared else 'vid'}"
        ada_t = (None if block_vid_only(dit, i)
                 else f"{b}.ada.{'all' if shared else 'txt'}")
        hv = mod(rms_norm(x, eps), e_attn, ada_v, "attn")
        ht = rms_norm(xt, eps)
        if ada_t is not None:
            ht = mod(ht, e_attn, ada_t, "attn")
        hv, ht = _attention(dit, p, b, shared, hv, ht, wins[i % 2 == 1],
                            txt_cos, txt_sin, quant)
        x = x + gate(hv, e_attn, ada_v, "attn")
        xt = xt + (gate(ht, e_attn, ada_t, "attn") if ada_t is not None
                   else ht)
        mlp_v = f"{b}.mlp.{'all' if shared else 'vid'}"
        x = x + gate(_mlp(p, mlp_v, mod(rms_norm(x, eps), e_mlp, ada_v, "mlp"),
                          dit["mlp_type"], quant), e_mlp, ada_v, "mlp")
        if ada_t is not None:
            mlp_t = f"{b}.mlp.{'all' if shared else 'txt'}"
            ht2 = mod(rms_norm(xt, eps), e_mlp, ada_t, "mlp")
            xt = xt + gate(_mlp(p, mlp_t, ht2, dit["mlp_type"], quant), e_mlp,
                           ada_t, "mlp")
    if dit["vid_out_norm"]:
        # the output modulation reads the blocks' attention shift and scale
        x = rms_norm(x, eps) * p("vid_out_norm.weight")
        x = x * (e_attn[:, 1] + p("vid_out_ada.out_scale")) + (
            e_attn[:, 0] + p("vid_out_ada.out_shift"))
    x = linear(p, "vid_out.proj", x, quant)
    co = dit["vid_out_channels"]
    x = x.reshape(T, grid[1], grid[2], ph, pw, co).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(T, Hh, Ww, co)
