"""Checkpoint loading: reference-layout DiT and VAE files -> port modules.

Port of the JAX package's loading (seedvr2_tpu.core.loader and the two
loaders of seedvr2_tpu.core.model_manager), numpy/torch only:

 - DiT (`load_dit_checkpoint`): `.safetensors` (fp8 upcast at read), `.pth`
   / `.pt` (`torch.load(weights_only=True)`) or `.gguf` (ops/gguf.py); the
   rope / freqs / dummy buffers dropped; the architecture sniffed from the
   tensor shapes (`sniff_dit_config`, falling back to the file name's
   family config when the sniffed tensors are quantised, as the JAX loader
   does); then the serving quantisation of `--quant`:

   | file     | quant            | result                                   |
   | .gguf    | q8/q4/q4k/w8a8   | Q8_0 tensors stay Q8 (keep_q8); other     |
   |          |                  | large quantised linears requantize to Q8 |
   | .gguf    | q4k              | also native Q4_K/Q5_K as affine          |
   | .gguf    | q4/q8/q4k        | served as the file has them (a warning)  |
   | float    | q4               | quantize_dit_affine4                     |
   | float    | q8/q4k           | quantize_dit_q8                          |
   | any      | w8a8             | quantize_dit_w8a8 (Q8 layers included)   |

   The NaDiT is built on the meta device, every linear whose state-dict
   entry is quantised is swapped for the module that entry asks for
   (ops.quant_matmul.Q8Linear / AffineLinear), the model is materialised on
   the target device and loaded with strict=True.
 - VAE (`load_vae_checkpoint`): the `model.` prefix stripped, deprecated
   attention names (query/key/value/proj_attn) renamed, (C, C, 1, 1)
   attention projections squeezed, the architecture sniffed
   (`sniff_vae_config`: VAE_V3's family or the legacy video_vae.py one, by
   its markers), 2D-stored convs inflated to 3D (`tail` mode), then a
   strict load.

Both families load: the base config is the file name's family
(`dit_config_for`, as in the JAX loader), or the 7B when the name says
nothing of it but the structure does (`sniff_family`: no SwiGLU gate in the
MLPs), so a 7B file under a neutral name is not built as a 3B.
"""

import os
import re
import warnings
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.dit.nadit import NaDiT
from ..models.vae.model import VideoAutoencoder
from ..ops import gguf
from ..ops.int8_matmul import quantize_dit_w8a8
from ..ops.layers import swiglu_hidden_dim
from ..ops.quant_matmul import (AffineLinear, Q8Linear, quantize_dit_affine4,
                                quantize_dit_q8)
from .configs import VAE_V3, DiTConfig, VAEConfig, dit_config_for
from .weights import read_safetensors, should_skip

QUANT_MODES = ("none", "q8", "q4", "q4k", "w8a8")

# deprecated diffusers attention key names -> modern
_VAE_KEY_FIXUPS = [
    (re.compile(r"\.query\."), ".to_q."),
    (re.compile(r"\.key\."), ".to_k."),
    (re.compile(r"\.value\."), ".to_v."),
    (re.compile(r"\.proj_attn\."), ".to_out.0."),
]

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def sniff_family(state: Dict) -> str:
    """The family a DiT state's structure shows, from its key names only (so
    quantised leaves are read too): the 7B's MLP is a plain proj_in /
    proj_out pair, every 3B block's is SwiGLU (proj_in_gate)."""
    mlp = [k for k in state if ".mlp." in k]
    if mlp and not any(".proj_in_gate." in k for k in mlp):
        return "dit_7b"
    return "dit_3b"


def _is_array(v) -> bool:
    """A loaded tensor (numpy or torch), not a quantised dict leaf."""
    return isinstance(v, (np.ndarray, torch.Tensor))


# ---------------------------------------------------------------- sniffing


def sniff_dit_config(state: Dict, base: DiTConfig) -> DiTConfig:
    """Infer the architecture dims from checkpoint tensor shapes (the JAX
    sniff_dit_config, both families): `base` supplies what shapes cannot
    express (family, rope/window flavour, patch size). Falls back to `base`
    unchanged when a required tensor is absent or a quantised dict leaf."""
    def get(*keys):
        for k in keys:
            v = state.get(k)
            if _is_array(v):
                return v
        return None

    qkv0 = get("blocks.0.attn.proj_qkv.vid.weight",
               "blocks.0.attn.proj_qkv.all.weight")
    vid_in = get("vid_in.proj.weight")
    norm_q = get("blocks.0.attn.norm_q.vid.weight",
                 "blocks.0.attn.norm_q.all.weight")
    vid_out = get("vid_out.proj.weight")
    if qkv0 is None or vid_in is None or norm_q is None or vid_out is None:
        return base

    D = int(vid_in.shape[0])
    head_dim = int(norm_q.shape[0])
    heads = int(qkv0.shape[0]) // 3 // head_dim
    pt, ph, pw = base.patch_size
    pprod = pt * ph * pw
    block_pat = re.compile(r"^blocks\.(\d+)\.")
    block_ids = {int(m.group(1)) for k in state
                 for m in [block_pat.match(k)] if m}
    txt_pat = re.compile(r"^blocks\.(\d+)\.attn\.proj_qkv\.txt\.")
    txt_blocks = {int(m.group(1)) for k in state
                  for m in [txt_pat.match(k)] if m}
    txt_in = get("txt_in.weight")
    swiglu = any(".proj_in_gate." in k for k in state)
    mlp_in = get("blocks.0.mlp.vid.proj_in.weight",
                 "blocks.0.mlp.all.proj_in.weight")
    expand_ratio = base.expand_ratio
    if mlp_in is not None:
        hidden = int(mlp_in.shape[0])
        if swiglu:
            # 256-rounding can map several ratios to one hidden dim at small
            # D; prefer the family default when it matches
            for r in (base.expand_ratio, 2, 3, 4, 6, 8):
                if swiglu_hidden_dim(D, r) == hidden:
                    expand_ratio = r
                    break
        else:
            expand_ratio = hidden // D

    kwargs = dict(
        vid_in_channels=int(vid_in.shape[1]) // pprod,
        vid_out_channels=int(vid_out.shape[0]) // pprod,
        vid_dim=D,
        txt_in_dim=int(txt_in.shape[1]) if txt_in is not None else D,
        heads=heads,
        head_dim=head_dim,
        expand_ratio=expand_ratio,
        qk_bias="blocks.0.attn.proj_qkv.vid.bias" in state
                or "blocks.0.attn.proj_qkv.all.bias" in state,
        num_layers=max(block_ids) + 1 if block_ids else base.num_layers,
        mlp_type="swiglu" if swiglu else "normal",
        vid_out_norm="vid_out_norm.weight" in state,
        upscaler=any(k.startswith("emb_scale.") for k in state),
    )
    if base.family == "dit_3b":
        kwargs["mm_layers"] = len(txt_blocks)
        kwargs["rope_dim"] = head_dim
    else:
        kwargs["shared_qkv"] = not txt_blocks
        kwargs["shared_mlp"] = not any(
            re.match(r"^blocks\.\d+\.mlp\.txt\.", k) for k in state)
        kwargs["rope_dim"] = head_dim // 2
    return replace(base, **kwargs)


def sniff_vae_config(state: Dict, base: VAEConfig) -> VAEConfig:
    """Infer the VAE architecture from checkpoint tensor shapes
    (reference-layout keys after the VAE key fixups); the JAX
    sniff_vae_config."""
    def get(k):
        v = state.get(k)
        return v if _is_array(v) else None

    conv_in = get("encoder.conv_in.weight")
    conv_out = get("encoder.conv_out.weight")
    if conv_in is None or conv_out is None:
        return base

    down_pat = re.compile(r"^encoder\.down_blocks\.(\d+)\.")
    n_blocks = 1 + max({int(m.group(1)) for k in state
                        for m in [down_pat.match(k)] if m}, default=-1)
    if n_blocks <= 0:
        return base
    chans = []
    for i in range(n_blocks):
        w = get(f"encoder.down_blocks.{i}.resnets.0.conv1.weight")
        if w is None:
            return base
        chans.append(int(w.shape[0]))
    res_pat = re.compile(r"^encoder\.down_blocks\.0\.resnets\.(\d+)\.")
    layers_per_block = 1 + max(int(m.group(1)) for k in state
                               for m in [res_pat.match(k)] if m)
    temporal_scale_num = 0
    saw_5d_downsampler = False
    for i in range(n_blocks - 1):
        w = get(f"encoder.down_blocks.{i}.downsamplers.0.conv.weight")
        if w is not None and w.ndim == 5:
            saw_5d_downsampler = True
            if w.shape[2] == 3:
                temporal_scale_num += 1
    if not saw_5d_downsampler and n_blocks > 1:
        # 2D-stored checkpoint: the temporal kernel depth is not in the
        # file; keep the base config's temporal structure
        temporal_scale_num = base.temporal_scale_num
    gcd = int(np.gcd.reduce(chans))
    groups = max(g for g in range(1, min(gcd, base.norm_num_groups) + 1)
                 if gcd % g == 0)
    # legacy family markers: 1x1x1 quant/post-quant convs, no mid-block
    # attention, a depth-1 resnet conv2 kernel (time_receptive_field="half")
    mid_attention = any(k.startswith("encoder.mid_block.attentions.")
                        for k in state)
    conv2 = get("encoder.down_blocks.0.resnets.0.conv2.weight")
    trf = ("half" if conv2 is not None and conv2.ndim == 5
           and conv2.shape[2] == 1 else base.time_receptive_field)
    dec_out = get("decoder.conv_out.weight")
    return VAEConfig(
        in_channels=int(conv_in.shape[1]),
        out_channels=(int(dec_out.shape[0]) if dec_out is not None
                      else base.out_channels),
        latent_channels=int(conv_out.shape[0]) // 2,
        block_out_channels=tuple(chans),
        layers_per_block=layers_per_block,
        norm_num_groups=groups,
        temporal_scale_num=temporal_scale_num,
        spatial_downsample_factor=2 ** (n_blocks - 1),
        temporal_downsample_factor=2 ** temporal_scale_num,
        slicing_sample_min_size=base.slicing_sample_min_size,
        scaling_factor=base.scaling_factor,
        shifting_factor=base.shifting_factor,
        time_receptive_field=trf,
        mid_attention=mid_attention,
        use_quant_conv=get("quant_conv.weight") is not None,
        use_post_quant_conv=get("post_quant_conv.weight") is not None,
    )


def vae_template_shapes(cfg: Optional[VAEConfig] = None) -> Dict[str, tuple]:
    """Reference-layout key -> weight shape of the port's VAE for `cfg`
    (built on the meta device: nothing is allocated). 2D->3D inflation reads
    each conv's temporal depth from it, which a 2D-stored checkpoint cannot
    express."""
    model = VideoAutoencoder(cfg or VAE_V3, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def inflate_vae_2d_convs(state: Dict, cfg: Optional[VAEConfig] = None
                         ) -> Dict:
    """Inflate 2D-stored conv weights (out, in, kh, kw) to the 3D causal
    layout (out, in, kt, kh, kw), as the JAX inflate_vae_2d_convs in its
    "tail" mode (the one its loader uses): zero temporal taps except the
    last, which carries the 2D weight, so a causal conv reproduces the 2D
    conv per frame. A 4D weight with no counterpart in the target
    architecture is carried through (with a warning); one whose spatial
    geometry disagrees raises. Values are torch tensors or numpy arrays;
    inflated ones come back as tensors of the same dtype."""
    four_d = [k for k, v in state.items()
              if k.endswith(".weight") and _is_array(v) and v.ndim == 4]
    if not four_d:
        return state
    template = vae_template_shapes(cfg)
    out = dict(state)
    for k in four_d:
        tgt = template.get(k)
        if tgt is None:
            warnings.warn(
                f"VAE checkpoint stores 4D weight {k!r} with no counterpart "
                "in the target architecture; carried through uninflated "
                "(unused by the model).", stacklevel=2)
            continue
        if len(tgt) == 4:
            continue  # a 2D conv in the target too: no inflation
        w2 = torch.as_tensor(state[k])
        o, i, kh, kw = w2.shape
        to, ti, kt, th, tw = tgt
        if (o, i, kh, kw) != (to, ti, th, tw):
            raise ValueError(
                f"VAE 2D conv weight {k!r} has shape {tuple(w2.shape)}, "
                f"incompatible with target 3D conv {tgt} — cannot inflate.")
        w3 = torch.zeros((to, ti, kt, th, tw), dtype=w2.dtype)
        w3[:, :, -1] = w2
        out[k] = w3
    return out


# ------------------------------------------------------------------ reading


def _upcast_fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """fp8 is storage only: widen it at load (exact in bf16 and fp32)."""
    return t.to(dtype) if t.dtype in _FP8 else t


def read_dit_state(path: str, quant: str = "none",
                   dtype=torch.bfloat16) -> Dict:
    """A DiT checkpoint's tensors by reference-layout key: torch tensors
    (safetensors in their stored dtype with fp8 widened to `dtype`; .pth),
    numpy arrays and quantised dict leaves (.gguf, see ops/gguf.py)."""
    if path.endswith(".gguf"):
        return gguf.load_gguf_state_dict(
            path, keep_q8=quant in ("q8", "q4k", "q4", "w8a8"),
            native_kquants=quant == "q4k")
    if path.endswith((".pth", ".pt")):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        raw = raw.get("state_dict", raw)
        return {k: _upcast_fp8(v, dtype) for k, v in raw.items()}
    return {k: _upcast_fp8(v, dtype)
            for k, v in read_safetensors(path).items()}


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
        v, np.ndarray) else v


def _model_state(model: nn.Module, state: Dict) -> Dict[str, torch.Tensor]:
    """The state dict to load into `model`: rope buffers dropped, and each
    quantised leaf {"q8", "scales"} / {"qa", "s", "m"} at `<layer>.weight`
    spread into `<layer>.<part>` keys after swapping the linear at <layer>
    for the module that reads them."""
    out = {}
    for key, val in state.items():
        if should_skip(key):
            continue
        if not isinstance(val, dict):
            out[key] = _tensor(val)
            continue
        layer = key[:-len(".weight")] if key.endswith(".weight") else key
        cls = Q8Linear if "q8" in val else AffineLinear
        parent_name, _, attr = layer.rpartition(".")
        try:
            lin = model.get_submodule(layer)
        except AttributeError:
            lin = None
        if not isinstance(lin, nn.Linear):
            raise RuntimeError(f"quantised tensor {key!r} has no linear "
                               "layer in the model to replace")
        setattr(model.get_submodule(parent_name), attr, cls.empty_like(lin))
        for part, arr in val.items():
            out[f"{layer}.{part}"] = _tensor(arr)
    return out


def load_dit_checkpoint(path: str, device, dtype=torch.bfloat16,
                        quant: str = "none", min_dim: int = 1024,
                        align: int = 256) -> NaDiT:
    """Load a reference-layout 3B or 7B DiT checkpoint (.safetensors, .pth,
    .pt or .gguf) onto `device` in `dtype`, quantised for serving per
    `quant` (the table in the module docstring). min_dim / align are the
    conversions' size rules (tests shrink them for tiny configs)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant={quant!r}; known: {QUANT_MODES}")
    base = dit_config_for(os.path.basename(path))
    state = read_dit_state(path, quant, dtype)
    if base.family == "dit_3b" and sniff_family(state) == "dit_7b":
        base = dit_config_for("dit_7b")  # a 7B under a neutral name
    cfg = sniff_dit_config(state, base)
    with torch.device("meta"):
        model = NaDiT(cfg, dtype=dtype)
    flat = _model_state(model, state)
    del state
    model = model.to_empty(device=device)
    model.load_state_dict(flat, strict=True)
    del flat
    return quantize_dit(model, quant, path.endswith(".gguf"), min_dim, align)


def quantize_dit(model: NaDiT, quant: str, from_gguf: bool = False,
                 min_dim: int = 1024, align: int = 256) -> NaDiT:
    """Apply `quant`'s serving quantization to a loaded DiT, in place (the
    lower rows of the module docstring's table): w8a8 converts any file; a
    float file (or random weights) gets q8 / q4 PTQ; a GGUF file keeps the
    quantisation it was read with, with the JAX loader's warning."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant={quant!r}; known: {QUANT_MODES}")
    if quant == "w8a8":
        quantize_dit_w8a8(model, min_dim, align)
    elif quant in ("q4", "q8", "q4k") and from_gguf:
        # a GGUF file serves the quantisation it carries (keep_q8 /
        # native_kquants at read); PTQ is not applied on top
        warnings.warn(
            f"--quant {quant} does not re-quantize GGUF checkpoints: "
            "the file's native format is served as-is (an F16 .gguf "
            "stays dense). Use a pre-quantized .gguf or a safetensors "
            "checkpoint for post-training quantization.",
            stacklevel=2)
    elif quant == "q4":
        quantize_dit_affine4(model, min_dim)
    elif quant in ("q8", "q4k"):
        quantize_dit_q8(model, min_dim)
    return model


def load_vae_checkpoint(path: str, device, dtype=torch.bfloat16,
                        vae_quant: str = "none") -> VideoAutoencoder:
    """Load a reference-layout VAE .safetensors onto `device` in `dtype`,
    with the JAX load_vae_checkpoint's key fixups, squeeze, sniffing and
    2D->3D inflation, then a strict load. A legacy-layout file (no mid
    attention, quant convs, (1, 3, 3) conv2) loads as its family; stored
    2D, its conv2 depth is not in the file and the base config's "full"
    stands, as in JAX. vae_quant "int8" sets the
    config's conv_quant, as the JAX model manager does after its load (the
    VideoVAE built on the model quantizes the served convs)."""
    fixed = {}
    for key, val in read_safetensors(path).items():
        if should_skip(key):
            continue
        if key.startswith("model."):
            key = key[len("model."):]
        for pat, repl in _VAE_KEY_FIXUPS:
            key = pat.sub(repl, key)
        # deprecated conv-style attention projections: (C, C, 1, 1) -> (C, C)
        if val.ndim == 4 and val.shape[2] == val.shape[3] == 1 and \
                any(t in key for t in ("to_q", "to_k", "to_v", "to_out")):
            val = val[:, :, 0, 0]
        fixed[key] = _upcast_fp8(val, dtype)
    cfg = sniff_vae_config(fixed, VAE_V3)
    fixed = inflate_vae_2d_convs(fixed, cfg)
    if vae_quant != "none":
        cfg = replace(cfg, conv_quant=vae_quant)
    model = VideoAutoencoder(cfg, device="meta", dtype=dtype).to_empty(
        device=device)
    model.load_state_dict(fixed, strict=True)
    return model
