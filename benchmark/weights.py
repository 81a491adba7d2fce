"""Seeded random weights for a configuration, drawn on the device.

The parameters are named as in the published checkpoints (the keys that
the program's modules and the plain reference both read). Every parameter
of one distribution lies in one flat buffer, filled by one call of a
`torch.Generator` on the device, in the type the weights are served in, so
that set-up pays a handful of launches and no host traffic whatever the
model's size. The distributions are the usual initialisation of each
layer: linears and convolutions U(+-1/sqrt(fan_in)) for weight and bias,
norm weights 1 and biases 0, the adaptive modulation's shift N(0, 1/D)
and its scale 1 + N(0, 1/D); the residual gates are wider (GATE_STD).
"""

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], tuple]]  # (key, shape, init)

# the blocks' residual gates: at the usual N(0, 1/D) the 36 blocks of
# random weights add next to nothing to the residual stream, and the
# denoiser's output is its input and output projections alone; at this
# scale each block's attention and MLP move the output as a trained
# model's do, so the comparison sees them
GATE_STD = 0.5


def _linear(out: List, key: str, d_in: int, d_out: int, bias: bool = True):
    init = ("uniform", d_in ** -0.5)
    out.append((f"{key}.weight", (d_out, d_in), init))
    if bias:
        out.append((f"{key}.bias", (d_out,), init))


def swiglu_hidden(dim: int, expand_ratio: int, multiple_of: int = 256):
    hidden = int(2 * dim * expand_ratio / 3)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)


def block_shared(dit: dict, i: int) -> bool:
    """Whether block i serves the video and text streams with one set of
    weights ("all"): the 3B's blocks past its first mm_layers."""
    if dit["family"] == "dit_3b":
        return i >= dit["mm_layers"]
    return bool(dit["shared_qkv"])


def block_vid_only(dit: dict, i: int) -> bool:
    """The 3B's last block has no text MLP and no text modulation."""
    return dit["family"] == "dit_3b" and i == dit["num_layers"] - 1


def dit_spec(dit: dict) -> Spec:
    """(key, shape, init) of every NaDiT parameter."""
    if dit.get("upscaler"):
        raise ValueError("the upscaler variant's emb_scale is not drawn")
    D, H, Dh = dit["vid_dim"], dit["heads"], dit["head_dim"]
    patch = dit["patch_size"][0] * dit["patch_size"][1] * dit["patch_size"][2]
    out: Spec = []
    _linear(out, "vid_in.proj", dit["vid_in_channels"] * patch, D)
    _linear(out, "emb_in.proj_in", 256, D)
    _linear(out, "emb_in.proj_hid", D, D)
    _linear(out, "emb_in.proj_out", D, 6 * D)
    _linear(out, "vid_out.proj", D, dit["vid_out_channels"] * patch)
    if dit["txt_in_dim"] and dit["txt_in_dim"] != D:
        _linear(out, "txt_in", dit["txt_in_dim"], D)
    ada_std = D ** -0.5
    for i in range(dit["num_layers"]):
        b = f"blocks.{i}"
        shared = block_shared(dit, i)
        branches = ["all"] if shared else ["vid", "txt"]
        norm_branches = branches if dit["family"] == "dit_3b" else ["vid", "txt"]
        mlp_branches = (["all"] if shared else ["vid"] if block_vid_only(dit, i)
                        else ["vid", "txt"])
        for br in branches:
            _linear(out, f"{b}.attn.proj_qkv.{br}", D, 3 * H * Dh,
                    dit["qk_bias"])
            _linear(out, f"{b}.attn.proj_out.{br}", H * Dh, D)
        for br in norm_branches:
            out.append((f"{b}.attn.norm_q.{br}.weight", (Dh,), ("const", 1.0)))
            out.append((f"{b}.attn.norm_k.{br}.weight", (Dh,), ("const", 1.0)))
        for br in mlp_branches:
            m = f"{b}.mlp.{br}"
            if dit["mlp_type"] == "swiglu":
                hid = swiglu_hidden(D, dit["expand_ratio"])
                _linear(out, f"{m}.proj_in_gate", D, hid, bias=False)
                _linear(out, f"{m}.proj_in", D, hid, bias=False)
                _linear(out, f"{m}.proj_out", hid, D, bias=False)
            else:
                hid = D * dit["expand_ratio"]
                _linear(out, f"{m}.proj_in", D, hid)
                _linear(out, f"{m}.proj_out", hid, D)
        for br in mlp_branches:
            for layer in ("attn", "mlp"):
                for kind, init in (("shift", ("normal", ada_std, 0.0)),
                                   ("scale", ("normal", ada_std, 1.0)),
                                   ("gate", ("normal", GATE_STD, 0.0))):
                    out.append((f"{b}.ada.{br}.{layer}_{kind}", (D,), init))
    if dit["vid_out_norm"]:
        out.append(("vid_out_norm.weight", (D,), ("const", 1.0)))
        out.append(("vid_out_ada.out_shift", (D,), ("normal", ada_std, 0.0)))
        out.append(("vid_out_ada.out_scale", (D,), ("normal", ada_std, 1.0)))
    return out


def _conv(out: Spec, key: str, ci: int, co: int, k=(3, 3, 3)):
    init = ("uniform", (ci * k[0] * k[1] * k[2]) ** -0.5)
    out.append((f"{key}.weight", (co, ci, *k), init))
    out.append((f"{key}.bias", (co,), init))


def _norm(out: Spec, key: str, c: int):
    out.append((f"{key}.weight", (c,), ("const", 1.0)))
    out.append((f"{key}.bias", (c,), ("const", 0.0)))


def _resnet(out: Spec, key: str, ci: int, co: int, conv2_kt: int):
    _norm(out, f"{key}.norm1", ci)
    _conv(out, f"{key}.conv1", ci, co)
    _norm(out, f"{key}.norm2", co)
    _conv(out, f"{key}.conv2", co, co, (conv2_kt, 3, 3))
    if ci != co:
        _conv(out, f"{key}.conv_shortcut", ci, co, (1, 1, 1))


def _mid(out: Spec, key: str, c: int, conv2_kt: int, attention: bool):
    _resnet(out, f"{key}.resnets.0", c, c, conv2_kt)
    _resnet(out, f"{key}.resnets.1", c, c, conv2_kt)
    if attention:
        a = f"{key}.attentions.0"
        _norm(out, f"{a}.group_norm", c)
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            _linear(out, f"{a}.{name}", c, c)


def vae_spec(vae: dict) -> Spec:
    """(key, shape, init) of every parameter of the causal video VAE."""
    chans = vae["block_out_channels"]
    n = len(chans)
    k2 = 1 if vae["time_receptive_field"] == "half" else 3
    lat = vae["latent_channels"]
    out: Spec = []
    _conv(out, "encoder.conv_in", vae["in_channels"], chans[0])
    ci = chans[0]
    for i, co in enumerate(chans):
        for j in range(vae["layers_per_block"]):
            _resnet(out, f"encoder.down_blocks.{i}.resnets.{j}",
                    ci if j == 0 else co, co, k2)
        if i < n - 1:
            kt = 3 if i >= n - vae["temporal_scale_num"] - 1 else 1
            _conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv", co, co,
                  (kt, 3, 3))
        ci = co
    _mid(out, "encoder.mid_block", chans[-1], k2, vae["mid_attention"])
    _norm(out, "encoder.conv_norm_out", chans[-1])
    _conv(out, "encoder.conv_out", chans[-1], 2 * lat)
    rev = list(reversed(chans))
    _conv(out, "decoder.conv_in", lat, rev[0])
    _mid(out, "decoder.mid_block", rev[0], k2, vae["mid_attention"])
    ci = rev[0]
    for i, co in enumerate(rev):
        for j in range(vae["layers_per_block"] + 1):
            _resnet(out, f"decoder.up_blocks.{i}.resnets.{j}",
                    ci if j == 0 else co, co, k2)
        if i < n - 1:
            ratio = 4 * (2 if i < vae["temporal_scale_num"] else 1)
            u = f"decoder.up_blocks.{i}.upsamplers.0"
            _conv(out, f"{u}.upscale_conv", co, co * ratio, (1, 1, 1))
            _conv(out, f"{u}.conv", co, co)
        ci = co
    _norm(out, "decoder.conv_norm_out", rev[-1])
    _conv(out, "decoder.conv_out", rev[-1], vae["out_channels"])
    if vae["use_quant_conv"]:
        _conv(out, "quant_conv", 2 * lat, 2 * lat, (1, 1, 1))
    if vae["use_post_quant_conv"]:
        _conv(out, "post_quant_conv", lat, lat, (1, 1, 1))
    return out


@torch.no_grad()
def draw(spec: Spec, generator: torch.Generator, dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    """A state dict for `spec` drawn from `generator` on its device: one flat
    buffer per distinct distribution, filled by one call, then cut into
    views in the spec's order."""
    by_init: "OrderedDict[tuple, list]" = OrderedDict()
    for key, shape, init in spec:
        by_init.setdefault(init, []).append((key, shape))
    state = {}
    for init, items in by_init.items():
        sizes = [int(torch.Size(shape).numel()) for _, shape in items]
        flat = torch.empty(sum(sizes), dtype=dtype, device=generator.device)
        kind = init[0]
        if kind == "uniform":
            flat.uniform_(-init[1], init[1], generator=generator)
        elif kind == "normal":
            flat.normal_(init[2], init[1], generator=generator)
        elif kind == "const":
            flat.fill_(init[1])
        else:
            raise ValueError(f"unknown init {init!r}")
        for (key, shape), part in zip(items, flat.split(sizes)):
            state[key] = part.view(shape)
    return {key: state[key] for key, _, _ in spec}
