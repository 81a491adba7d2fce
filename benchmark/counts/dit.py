"""The NaDiT's counted work in one request: its linears (bf16, or int8 on
kernel K3 in the w8a8 lane) and its windowed attention (kernel K1)."""

from typing import List, Tuple

from ..reference import geometry
from ..weights import block_vid_only, swiglu_hidden
from .work import Work, linear


def grid(dit: dict, latent: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The token grid (T, H/2, W/2) of a latent (T, H, W)."""
    pt, ph, pw = dit["patch_size"]
    t, h, w = latent
    return t // pt, h // ph, w // pw


def attention_windows(dit: dict, latent, txt_len: int, shifted: bool):
    """(windows, rows) of each window shape of one block: every window
    attends over its own tokens and the text, both as queries and keys."""
    groups, _ = geometry.window_groups(grid(dit, latent), dit["window"],
                                       shifted)
    return [(idx.shape[0], idx.shape[1] + txt_len) for _, idx in groups]


def k1(dit: dict, latent, txt_len: int, shifted: bool) -> Work:
    """One block's windowed attention (kernel K1 and its pre-pass): 4 S^2 D
    operations a head and window (scores and values), the packed qkv rows
    read and the output rows written once, the four rope tables read."""
    H, Dh = dit["heads"], dit["head_dim"]
    ops = nbytes = 0.0
    for n, s in attention_windows(dit, latent, txt_len, shifted):
        ops += 4.0 * n * s * s * H * Dh
        nbytes += n * s * 4 * H * Dh * 2 + 4 * s * Dh * 4
    return Work("dit", "attention", ops, nbytes, "bf16", "k1")


def dit_request(dit: dict, latent, txt_len: int, quant: str) -> List[Work]:
    """Every counted product of one NaDiT forward over a latent (T, H, W)
    with txt_len text tokens."""
    D, H, Dh = dit["vid_dim"], dit["heads"], dit["head_dim"]
    pt, ph, pw = dit["patch_size"]
    t, h, w = grid(dit, latent)
    L = t * h * w
    out = [linear(L, dit["vid_in_channels"] * pt * ph * pw, D, quant),
           linear(1, 256, D, quant), linear(1, D, D, quant),
           linear(1, D, 6 * D, quant),
           linear(L, D, dit["vid_out_channels"] * pt * ph * pw, quant)]
    if dit["txt_in_dim"] and dit["txt_in_dim"] != D:
        out.append(linear(txt_len, dit["txt_in_dim"], D, quant))
    if dit["mlp_type"] == "swiglu":
        hid = swiglu_hidden(D, dit["expand_ratio"])
    else:
        hid = D * dit["expand_ratio"]
    for i in range(dit["num_layers"]):
        rows = [L, txt_len]
        for m in rows:
            out.append(linear(m, D, 3 * H * Dh, quant, dit["qk_bias"]))
            out.append(linear(m, H * Dh, D, quant))
        out.append(k1(dit, (t * pt, h * ph, w * pw), txt_len, i % 2 == 1))
        mlp_rows = [L] if block_vid_only(dit, i) else rows
        for m in mlp_rows:
            if dit["mlp_type"] == "swiglu":
                out.append(linear(m, D, 2 * hid, quant, bias=False))
                out.append(linear(m, hid, D, quant, bias=False))
            else:
                out.append(linear(m, D, hid, quant))
                out.append(linear(m, hid, D, quant))
    return out
