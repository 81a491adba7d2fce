"""Causal video VAE (s8_c16_t4).

Port of seedvr2_tpu.models.vae.model, both families: the attn_video_vae
layout (VAE_V3) and the legacy video_vae.py layout (time_receptive_field
"half": resnet conv2 (1, 3, 3); no mid-block attention; 1x1x1 quant_conv /
post_quant_conv around the latent, each switch its own config field). Plain
causal 3D convs (cuDNN),
per-frame group norm with fp32 statistics, the mid-block spatial attention
as a plain matmul/softmax composition; the JAX package's three lowering
switches (`Lowering`: the decoder upsample as a transposed conv, the
default, or as a matmul plus pixel shuffle; the causal head as a
correction conv; small convs as an im2col matmul); on the card every
decoder upsample is one hand-written kernel instead, whatever the switch
says (ops/upsample.py: the widening conv, its bias, the pixel
shuffle, the first slice's frame drop and the next conv's causal head in
one launch); and the two opt-in
lowerings of norm -> SiLU -> conv, in the JAX order:
 - `conv_quant="int8"` (--vae_quant int8): the decoder's resnet convs run
   as int8 convs (ops/int8_conv.py, kernel K11) on a fused
   norm+SiLU+quantize of their input;
 - `Lowering.fused_norm` (SEEDVR2_FUSED_NORM=1): a first slice's norm ->
   SiLU -> 3x3x3 conv takes the fused norm+SiLU+head pass
   (ops/fused_norm.py, kernel K12).

 - The reference's mutable per-conv temporal memory is an explicit state
   dict: every causal conv reads `state[path]` and writes `new_state[path]`,
   so temporal slicing is (y, state) = f(model, x, state).
 - The public cores (`encoder_core`, `decoder_core`) take and return
   channels-last NDHWC tensors like the JAX package; inside they run in
   PyTorch's NCDHW, the layout cuDNN's 3D convolutions take.
 - `VideoAutoencoder`'s state_dict keys are the reference checkpoint names
   (encoder.down_blocks.0.resnets.0.conv1.weight, ...).

Causal semantics: the first slice prepends its first frame 2*pad_t times;
later slices prepend the stored tail of the previous *extended* input
(k_t - s_t frames). The decoder's temporal upsample duplicates frame 0, so
the first slice drops frame 1 after it.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.configs import VAEConfig
from ...ops import fused_norm, int8_conv, upsample
from ...utils import spans

State = Optional[Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class Lowering:
    """How the cores lower their convs, beside the config's conv_quant; the
    defaults are the JAX package's.

    fused_norm: a first slice's norm -> SiLU -> 3x3x3 conv takes K12's fused
    pass (SEEDVR2_FUSED_NORM=1). use_kernels: False runs the plain versions
    of K11 and K12, and the upsample's plain forms, on any device, to hold
    the kernels against them (and for an fp32 VAE on the card).
    upsample_convt: the decoder upsample as one transposed conv
    (SEEDVR2_UPSAMPLE_CONVT, on by default); off, a 1x1x1 conv as a matmul
    plus the pixel shuffle. On the card every decode's upsample takes the
    upsample kernel (ops/upsample.py) under use_kernels whatever this
    says (it raises on a tensor it cannot take, e.g. not bf16); the switch
    picks only the plain form (the CPU, use_kernels False).
    head_correction: a causal conv whose head frames
    come from the state or the first frame runs over x zero-padded at the
    front of T, plus a conv over the head added onto the first kt - 1
    output frames (SEEDVR2_HEAD_CORRECTION=1). im2col_max_k: stride-1 convs
    with kt*kh*kw*ci <= this run as a tap-major patch matmul
    (SEEDVR2_CONV_IM2COL=1 sets 128; 0 is off)."""

    fused_norm: bool = False
    use_kernels: bool = True
    upsample_convt: bool = True
    head_correction: bool = False
    im2col_max_k: int = 0

# --------------------------------------------------------------------------
# Modules (state_dict keys = reference checkpoint names)
# --------------------------------------------------------------------------


def _conv(ci, co, k=(3, 3, 3), **fk):
    return nn.Conv3d(ci, co, k, **fk)


def _norm(c, groups, **fk):
    return nn.GroupNorm(groups, c, **fk)


class ResnetBlock(nn.Module):
    """conv2 is (1, 3, 3) when conv2_kt is 1 (time_receptive_field "half");
    the forward derives each conv's causal pad from its depth."""

    def __init__(self, ci, co, groups, conv2_kt=3, **fk):
        super().__init__()
        self.norm1 = _norm(ci, groups, **fk)
        self.conv1 = _conv(ci, co, **fk)
        self.norm2 = _norm(co, groups, **fk)
        self.conv2 = _conv(co, co, (conv2_kt, 3, 3), **fk)
        self.conv_shortcut = _conv(ci, co, (1, 1, 1), **fk) if ci != co else None


class AttnBlock(nn.Module):
    def __init__(self, c, groups, **fk):
        super().__init__()
        self.group_norm = _norm(c, groups, **fk)
        self.to_q = nn.Linear(c, c, **fk)
        self.to_k = nn.Linear(c, c, **fk)
        self.to_v = nn.Linear(c, c, **fk)
        self.to_out = nn.ModuleList([nn.Linear(c, c, **fk)])


class MidBlock(nn.Module):
    """resnet -> spatial attention -> resnet; the legacy family has no
    attention (attention=False: no `attentions` module)."""

    def __init__(self, c, groups, conv2_kt=3, attention=True, **fk):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(c, c, groups, conv2_kt, **fk),
            ResnetBlock(c, c, groups, conv2_kt, **fk)])
        if attention:
            self.attentions = nn.ModuleList([AttnBlock(c, groups, **fk)])


class _ConvHolder(nn.Module):
    def __init__(self, **convs):
        super().__init__()
        for name, conv in convs.items():
            self.add_module(name, conv)


def _conv2_kt(cfg: VAEConfig) -> int:
    return 1 if cfg.time_receptive_field == "half" else 3


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **fk):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        n, k2 = len(chans), _conv2_kt(cfg)
        self.conv_in = _conv(cfg.in_channels, chans[0], **fk)
        self.down_blocks = nn.ModuleList()
        in_ch = chans[0]
        for i, out_ch in enumerate(chans):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g, k2, **fk)
                for j in range(cfg.layers_per_block))
            if i < n - 1:
                kt = 3 if i >= n - cfg.temporal_scale_num - 1 else 1
                blk.downsamplers = nn.ModuleList([_ConvHolder(
                    conv=_conv(out_ch, out_ch, (kt, 3, 3), **fk))])
            self.down_blocks.append(blk)
            in_ch = out_ch
        self.mid_block = MidBlock(chans[-1], g, k2, cfg.mid_attention, **fk)
        self.conv_norm_out = _norm(chans[-1], g, **fk)
        self.conv_out = _conv(chans[-1], 2 * cfg.latent_channels, **fk)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **fk):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        n, k2 = len(rev), _conv2_kt(cfg)
        self.conv_in = _conv(cfg.latent_channels, rev[0], **fk)
        self.mid_block = MidBlock(rev[0], g, k2, cfg.mid_attention, **fk)
        self.up_blocks = nn.ModuleList()
        in_ch = rev[0]
        for i, out_ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g, k2, **fk)
                for j in range(cfg.layers_per_block + 1))
            if i < n - 1:
                ratio = 4 * (2 if i < cfg.temporal_scale_num else 1)
                blk.upsamplers = nn.ModuleList([_ConvHolder(
                    upscale_conv=_conv(out_ch, out_ch * ratio, (1, 1, 1), **fk),
                    conv=_conv(out_ch, out_ch, **fk))])
            self.up_blocks.append(blk)
            in_ch = out_ch
        self.conv_norm_out = _norm(rev[-1], g, **fk)
        self.conv_out = _conv(rev[-1], cfg.out_channels, **fk)


class VideoAutoencoder(nn.Module):
    """Parameter container of the causal VAE; the cores below run it. The
    legacy family's quant_conv (over the moments) and post_quant_conv (over
    the latent) are 1x1x1 convs, present when the config asks for them."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        if cfg.time_receptive_field not in ("full", "half"):
            raise ValueError(f"time_receptive_field="
                             f"{cfg.time_receptive_field!r}; known: full, "
                             "half")
        if cfg.conv_quant not in ("none", "int8"):
            raise ValueError(f"conv_quant={cfg.conv_quant!r}; known: none, "
                             "int8")
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.encoder = Encoder(cfg, **fk)
        self.decoder = Decoder(cfg, **fk)
        moments, lat = 2 * cfg.latent_channels, cfg.latent_channels
        if cfg.use_quant_conv:
            self.quant_conv = _conv(moments, moments, (1, 1, 1), **fk)
        if cfg.use_post_quant_conv:
            self.post_quant_conv = _conv(lat, lat, (1, 1, 1), **fk)


# --------------------------------------------------------------------------
# Layers (internal layout NCDHW)
# --------------------------------------------------------------------------


def _conv3d(x: torch.Tensor, w: torch.Tensor, stride, s_pad,
            t_pad=(0, 0)) -> torch.Tensor:
    """F.conv3d with the spatial pads `s_pad` and the temporal pads `t_pad`
    (front, back) applied as given (F.conv3d pads each axis symmetrically,
    so uneven pads are written out)."""
    (ph0, ph1), (pw0, pw1) = s_pad
    if ph0 == ph1 and pw0 == pw1 and t_pad[0] == t_pad[1]:
        return F.conv3d(x, w, None, stride, (t_pad[0], ph0, pw0))
    return F.conv3d(F.pad(x, (pw0, pw1, ph0, ph1, *t_pad)), w, None, stride)


def _conv3d_im2col(x_ext: torch.Tensor, w: torch.Tensor,
                   s_pad) -> torch.Tensor:
    """A stride-1 3D conv as the JAX package's tap-major patch matmul: the
    same taps, the products summed in fp32 by the matmul and rounded once
    to x's dtype. x_ext (B, Ci, T, H, W), w (Co, Ci, kt, kh, kw)."""
    co, ci, kt, kh, kw = w.shape
    (ph0, ph1), (pw0, pw1) = s_pad
    xp = F.pad(x_ext, (pw0, pw1, ph0, ph1)).permute(0, 2, 3, 4, 1)
    T = xp.shape[1] - (kt - 1)
    H = xp.shape[2] - (kh - 1)
    W = xp.shape[3] - (kw - 1)
    taps = [xp[:, dt:dt + T, dh:dh + H, dw:dw + W, :]
            for dt in range(kt) for dh in range(kh) for dw in range(kw)]
    m = torch.stack(taps, dim=-2).reshape(xp.shape[0], T, H, W,
                                          kt * kh * kw * ci)
    wk = w.permute(2, 3, 4, 1, 0).reshape(kt * kh * kw * ci, co)
    return torch.matmul(m, wk).permute(0, 4, 1, 2, 3)


def head_frames(state: State, path: str, t_pad: int) -> int:
    """The causal head's frames of the conv at `path`: the carried tail's,
    or 2 * t_pad copies of frame 0 on a first slice."""
    if state is not None and path in state:
        return state[path].shape[2]
    return 2 * t_pad


def corrects_head(lowering: Lowering, kt: int, stride, t: int,
                  n_head: int) -> bool:
    """Whether causal_conv3d runs a conv of depth kt over t frames with an
    n_head-frame head as the head correction (a conv over x plus one over
    the head) rather than over the head frames concatenated in front of x.
    The decoder's upsample asks too, to write its output extended or not."""
    return (lowering.head_correction and tuple(stride) == (1, 1, 1)
            and kt > 1 and t >= kt - stride[0] and n_head == kt - 1)


def causal_conv3d(conv: nn.Conv3d, path: str, x: torch.Tensor, state: State,
                  new_state: State = None,
                  stride: Tuple[int, int, int] = (1, 1, 1), t_pad: int = 0,
                  s_pad=((0, 0), (0, 0)),
                  pre_extended: bool = False,
                  lowering: Lowering = Lowering()) -> torch.Tensor:
    """Causal 3D convolution with functional temporal memory.

    x: (B, C, T, H, W). `state` holds the previous slice's tails (None for a
    first or unsliced call); `new_state`, if a dict, receives this slice's
    tail under `path` for the next call. pre_extended: the caller already
    prepended the causal head frames (K12's fused pass, the upsample
    kernel), so the head correction never applies. `lowering` picks the
    head correction and the im2col form, in the JAX order."""
    w = conv.weight.to(x.dtype)
    kt = w.shape[2]
    cache = kt - stride[0]
    bias = conv.bias.to(x.dtype).view(1, -1, 1, 1, 1)
    n_head = head_frames(state, path, t_pad)
    if not pre_extended and corrects_head(lowering, kt, stride, x.shape[2],
                                          n_head):
        carried = state is not None and path in state
        head = (state[path].to(x.dtype) if carried
                else x[:, :, :1].expand(-1, -1, n_head, -1, -1))
        if new_state is not None and cache > 0:
            new_state[path] = x[:, :, -cache:].clone()
        # JAX's conv over x zero-padded at the front of T, without the
        # padded copy of x: frames kt - 1 on are a conv over x unpadded,
        # the first kt - 1 one over x's first kt - 1 frames padded at
        # the front, onto which the conv over the head alone, padded at
        # the back so its taps line up, is added; both written with
        # the bias into one output
        n = kt - 1
        first = (_conv3d(x[:, :, :n], w, stride, s_pad, (n, 0))
                 + _conv3d(head, w, stride, s_pad, (0, n)))
        out = first.new_empty(first.shape[:2] + (x.shape[2],)
                              + first.shape[3:])
        torch.add(first, bias, out=out[:, :, :n])
        if x.shape[2] > n:
            torch.add(_conv3d(x, w, stride, s_pad), bias,
                      out=out[:, :, n:])
        return out
    if pre_extended:
        x_ext = x
    elif state is not None and path in state:
        x_ext = torch.cat([state[path].to(x.dtype), x], dim=2)
    elif t_pad > 0:
        head = x[:, :, :1].expand(-1, -1, 2 * t_pad, -1, -1)
        x_ext = torch.cat([head, x], dim=2)
    else:
        x_ext = x
    if new_state is not None and cache > 0:
        new_state[path] = x_ext[:, :, -cache:].clone()
    if (w[0].numel() <= lowering.im2col_max_k
            and tuple(stride) == (1, 1, 1)):
        return _conv3d_im2col(x_ext, w, s_pad) + bias
    return _conv3d(x_ext, w, stride, s_pad) + bias


def frame_group_norm(norm: nn.GroupNorm, x: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm with per-frame statistics (causal_norm_wrapper semantics):
    x (B, C, T, H, W), statistics per (b, group, t) over (c/g, h, w) in
    fp32 from one pass of E[x] and E[x^2]."""
    b, c, t, h, w = x.shape
    g = norm.num_groups
    xr = x.reshape(b, g, c // g, t, h * w)
    n = (c // g) * h * w
    mean = xr.mean(dim=(2, 4), keepdim=True, dtype=torch.float32)
    meansq = torch.linalg.vector_norm(xr, 2, dim=(2, 4), keepdim=True,
                                      dtype=torch.float32).square() / n
    var = torch.clamp(meansq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    wgt = norm.weight.float().view(1, g, c // g, 1, 1)
    bias = norm.bias.float().view(1, g, c // g, 1, 1)
    out = ((xr.float() - mean) * inv) * wgt + bias
    return out.to(x.dtype).reshape(b, c, t, h, w)


def _int8_norm_silu_conv(norm: nn.GroupNorm, conv: nn.Conv3d, path: str,
                         x: torch.Tensor, state: State, new_state: State,
                         use_kernels: bool) -> torch.Tensor:
    """norm -> SiLU -> int8 quantize written as K11's extended input, K11
    with the bias, for one batch element. A later slice quantizes its
    carried bf16 tail with the same scale; the new tail (the post-SiLU last
    two frames) goes to new_state. Weights quantized at VideoVAE
    construction (`wq`, `ws` buffers), else here."""
    head = state.get(path) if state is not None else None
    # a span: profile_requests reports its range's device time
    with spans.span("norm_silu_quantize"):
        x_ext, scale, tail = int8_conv.norm_silu_quantize_cthw(
            x[0], norm.weight, norm.bias, norm.num_groups,
            head=None if head is None else head[0],
            with_tail=new_state is not None)
    if new_state is not None:
        new_state[path] = tail[None]
    if hasattr(conv, "wq"):
        wk, ws = conv.wq, conv.ws
    else:
        wk, ws = int8_conv.conv_weight_int8(conv.weight)
    xs = scale.reshape(1).expand(x.shape[2]).contiguous()
    if use_kernels:
        return int8_conv.int8_conv3d_ncdhw(x_ext, wk, xs, ws, conv.bias,
                                           x.shape[4])
    return int8_conv.int8_conv3d_plain(x_ext, wk, xs, ws, conv.bias,
                                       x.shape[4])[None]


def norm_silu_conv(norm: nn.GroupNorm, conv: nn.Conv3d, path: str,
                   x: torch.Tensor, state: State, new_state: State,
                   conv_quant: str = "none",
                   lowering: Lowering = Lowering()) -> torch.Tensor:
    """GroupNorm -> SiLU -> causal conv; the temporal pad comes from the
    conv's kernel depth. In the JAX order: int8 (K11) when conv_quant is
    "int8", the batch is 1, the kernel 3 deep and the shape viable (the
    others, conv_out's Co = 3 among them, stay bf16); otherwise, for a first
    slice's 3-deep conv with fused_norm on, K12's fused norm+SiLU+head."""
    kt = conv.weight.shape[2]
    if (conv_quant == "int8" and x.shape[0] == 1 and kt == 3
            and int8_conv.int8_conv_viable(conv.in_channels,
                                           conv.out_channels, x.shape[4])):
        return _int8_norm_silu_conv(norm, conv, path, x, state, new_state,
                                    lowering.use_kernels)
    if state is None and kt == 3 and lowering.fused_norm:
        fn = (fused_norm.norm_silu_head_ncdhw if lowering.use_kernels
              else fused_norm.norm_silu_head_plain)
        # the mid block's attention returns a permuted sum; K12 reads NCDHW
        ext = fn(x.contiguous(), norm.weight, norm.bias, norm.num_groups)
        return causal_conv3d(conv, path, ext, None, new_state, t_pad=1,
                             s_pad=((1, 1), (1, 1)), pre_extended=True,
                             lowering=lowering)
    h = F.silu(frame_group_norm(norm, x))
    return causal_conv3d(conv, path, h, state, new_state,
                         t_pad=(kt - 1) // 2, s_pad=((1, 1), (1, 1)),
                         lowering=lowering)


def resnet_block(blk: ResnetBlock, path: str, x: torch.Tensor, state: State,
                 new_state: State, conv_quant: str = "none",
                 lowering: Lowering = Lowering()) -> torch.Tensor:
    h = norm_silu_conv(blk.norm1, blk.conv1, f"{path}.conv1", x, state,
                       new_state, conv_quant, lowering)
    h = norm_silu_conv(blk.norm2, blk.conv2, f"{path}.conv2", h, state,
                       new_state, conv_quant, lowering)
    if blk.conv_shortcut is not None:
        x = causal_conv3d(blk.conv_shortcut, f"{path}.conv_shortcut", x, state,
                          new_state, lowering=lowering)
    return x + h


_ATTN_Q_CHUNK = 4096  # query rows per softmax chunk


def _spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """(N, S, C) single-head attention as a plain composition: fp32 logits
    from the operands' exact products, fp32 softmax, probabilities rounded
    to v's dtype, fp32-accumulated p@v. Query rows go in chunks so the
    (S, S) logits never materialise at once (a 1080p latent has S = 32400);
    each row's softmax is still exact over every key."""
    k32, v32 = k.float(), v.float()
    out = torch.empty_like(q)
    for s0 in range(0, q.shape[1], _ATTN_Q_CHUNK):
        qc = q[:, s0:s0 + _ATTN_Q_CHUNK].float()
        logits = torch.matmul(qc, k32.transpose(1, 2)) * scale
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out[:, s0:s0 + _ATTN_Q_CHUNK] = torch.matmul(probs.float(), v32).to(
            q.dtype)
    return out


def attn_block(blk: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    """Per-frame single-head spatial attention (UNetMidBlock3D attention):
    group norm -> q,k,v linear -> softmax(QK^T / sqrt(C)) -> out linear ->
    residual."""
    b, c, t, h, w = x.shape
    hid = frame_group_norm(blk.group_norm, x)
    hid = hid.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)

    def lin(layer, z):
        return torch.matmul(z, layer.weight.to(z.dtype).t()) + layer.bias.to(
            z.dtype)

    q, k, v = lin(blk.to_q, hid), lin(blk.to_k, hid), lin(blk.to_v, hid)
    out = lin(blk.to_out[0], _spatial_attention(q, k, v, c ** -0.5))
    return out.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3) + x


def _mid_block(blk: MidBlock, path: str, x, state, new_state,
               conv_quant: str, lowering: Lowering):
    """resnet -> (spatial attention, absent in the legacy family) ->
    resnet."""
    x = resnet_block(blk.resnets[0], f"{path}.resnets.0", x, state, new_state,
                     conv_quant, lowering)
    if hasattr(blk, "attentions"):
        x = attn_block(blk.attentions[0], x)
    return resnet_block(blk.resnets[1], f"{path}.resnets.1", x, state,
                        new_state, conv_quant, lowering)


def _upsample_conv_transpose(conv: nn.Conv3d, x: torch.Tensor, sr: int,
                             tr: int) -> torch.Tensor:
    """upscale_conv (1x1x1, ci -> c*sr*sr*tr) + pixel shuffle as ONE
    transposed conv whose kernel equals its stride (a pure scatter):
    out[b, c, t*tr+z, h*sr+xi, w*sr+yi] = x[b, :, t, h, w] @
    W[((xi*sr+yi)*tr+z)*C + c, :]. The phase-dependent bias of the
    reference's conv broadcasts over free dim splits."""
    ci = x.shape[1]
    c = conv.weight.shape[0] // (sr * sr * tr)
    k = conv.weight[:, :, 0, 0, 0].to(x.dtype).reshape(sr, sr, tr, c, ci)
    k = k.permute(4, 3, 2, 0, 1)                  # (ci, c, tr, sr, sr)
    y = F.conv_transpose3d(x, k, stride=(tr, sr, sr))
    b, _, t, h, wd = x.shape
    bias = conv.bias.to(x.dtype).reshape(sr, sr, tr, c).permute(3, 2, 0, 1)
    y = y.reshape(b, c, t, tr, h, sr, wd, sr) + bias.reshape(
        1, c, 1, tr, 1, sr, 1, sr)
    return y.reshape(b, c, t * tr, h * sr, wd * sr)


def _upsample_pixel_shuffle(conv: nn.Conv3d, x: torch.Tensor, sr: int,
                            tr: int) -> torch.Tensor:
    """upscale_conv (1x1x1, ci -> c*sr*sr*tr) as one matmul with fp32
    accumulation, the bias, then the MAGViT pixel shuffle with channel
    group order (x, y, z, c): out[b, c, t*tr+z, h*sr+xi, w*sr+yi] =
    y[b, ((xi*sr+yi)*tr+z)*C + c, t, h, w], the JAX package's
    `_pixel_shuffle_3d` in NCDHW."""
    b, ci, t, h, wd = x.shape
    o = conv.weight.shape[0]
    c = o // (sr * sr * tr)
    y = torch.matmul(conv.weight[:, :, 0, 0, 0].to(x.dtype),
                     x.reshape(b, ci, t * h * wd))
    y.add_(conv.bias.to(x.dtype).view(1, o, 1))
    y = y.view(b, sr, sr, tr, c, t, h, wd).permute(0, 4, 5, 3, 6, 1, 7, 2)
    return y.reshape(b, c, t * tr, h * sr, wd * sr)


def _upsample_kernel(x: torch.Tensor, lowering: Lowering) -> bool:
    """Whether the decoder's upsample takes the upsample kernel
    (ops/upsample.py): a tensor on the card under use_kernels. The CPU and
    use_kernels False keep the two plain forms, chosen by upsample_convt."""
    return lowering.use_kernels and x.is_cuda


def _upsample3d(up: _ConvHolder, path: str, x, state, new_state,
                temporal_up: bool, first_slice: bool,
                lowering: Lowering = Lowering()):
    tr = 2 if temporal_up else 1
    # remove_head: a first slice drops the duplicated frame 1
    drop = temporal_up and first_slice
    conv_path, s_pad = f"{path}.conv", ((1, 1), (1, 1))
    if _upsample_kernel(x, lowering):
        # one launch writes the conv's input, extended by its causal head
        # unless the conv corrects the head itself
        n_head = head_frames(state, conv_path, 1)
        t_out = x.shape[2] * tr - drop
        extend = not corrects_head(lowering, up.conv.weight.shape[2],
                                   (1, 1, 1), t_out, n_head)
        head = (state.get(conv_path) if extend and state is not None
                else None)
        y = upsample.upsample_shuffle(
            x, up.upscale_conv.weight, up.upscale_conv.bias, tr, drop,
            n_head if extend else 0, head)
        return causal_conv3d(up.conv, conv_path, y, state, new_state,
                             t_pad=1, s_pad=s_pad, pre_extended=extend,
                             lowering=lowering)
    form = (_upsample_conv_transpose if lowering.upsample_convt
            else _upsample_pixel_shuffle)
    y = form(up.upscale_conv, x, 2, tr)
    if drop:
        y = torch.cat([y[:, :, :1], y[:, :, 2:]], dim=2)
    return causal_conv3d(up.conv, conv_path, y, state, new_state,
                         t_pad=1, s_pad=s_pad, lowering=lowering)


# --------------------------------------------------------------------------
# Encoder / decoder cores (one temporal slice; NDHWC in and out)
# --------------------------------------------------------------------------


def encoder_core(vae: VideoAutoencoder, x: torch.Tensor, state: State,
                 keep_state: bool = True, lowering: Lowering = Lowering()
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, H, W, 3) in [-1, 1] -> moments (B, Tl, H/8, W/8, 2*latent).

    state=None means the first slice. Returns (moments, new_state); with
    keep_state=False no tails are kept (the last or only slice). The
    encoder's convs stay bf16 under conv_quant, as in the JAX package."""
    cfg, enc = vae.cfg, vae.encoder
    new_state: State = {} if keep_state else None
    n_blocks = len(cfg.block_out_channels)
    x = x.permute(0, 4, 1, 2, 3).contiguous()
    x = causal_conv3d(enc.conv_in, "encoder.conv_in", x, state, new_state,
                      t_pad=1, s_pad=((1, 1), (1, 1)), lowering=lowering)
    for i, blk in enumerate(enc.down_blocks):
        base = f"encoder.down_blocks.{i}"
        for j, res in enumerate(blk.resnets):
            x = resnet_block(res, f"{base}.resnets.{j}", x, state, new_state,
                             lowering=lowering)
        if i < n_blocks - 1:
            temporal_down = i >= n_blocks - cfg.temporal_scale_num - 1
            # Downsample3D: spatial stride 2 with asymmetric (0, 1) pad,
            # temporal stride 2 causal when enabled
            x = causal_conv3d(
                blk.downsamplers[0].conv, f"{base}.downsamplers.0.conv", x,
                state, new_state, stride=(2 if temporal_down else 1, 2, 2),
                t_pad=1 if temporal_down else 0, s_pad=((0, 1), (0, 1)),
                lowering=lowering)
    x = _mid_block(enc.mid_block, "encoder.mid_block", x, state, new_state,
                   "none", lowering)
    x = norm_silu_conv(enc.conv_norm_out, enc.conv_out, "encoder.conv_out", x,
                       state, new_state, lowering=lowering)
    if cfg.use_quant_conv:
        # 1x1x1 over the moments: depth 1, so no temporal state
        x = causal_conv3d(vae.quant_conv, "quant_conv", x, state, new_state,
                          lowering=lowering)
    return x.permute(0, 2, 3, 4, 1), (new_state or {})


def decoder_core(vae: VideoAutoencoder, z: torch.Tensor, state: State,
                 keep_state: bool = True, lowering: Lowering = Lowering()
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """z: (B, Tl, h, w, latent) -> (B, T, 8h, 8w, 3). state as encoder_core;
    cfg.conv_quant reaches the mid block, the resnets and conv_out."""
    cfg, dec = vae.cfg, vae.decoder
    cq = cfg.conv_quant
    new_state: State = {} if keep_state else None
    first_slice = state is None
    n_blocks = len(cfg.block_out_channels)
    x = z.permute(0, 4, 1, 2, 3).contiguous()
    if cfg.use_post_quant_conv:
        # 1x1x1 over the latent: depth 1, so no temporal state
        x = causal_conv3d(vae.post_quant_conv, "post_quant_conv", x, state,
                          new_state, lowering=lowering)
    x = causal_conv3d(dec.conv_in, "decoder.conv_in", x, state, new_state,
                      t_pad=1, s_pad=((1, 1), (1, 1)), lowering=lowering)
    x = _mid_block(dec.mid_block, "decoder.mid_block", x, state, new_state,
                   cq, lowering)
    for i, blk in enumerate(dec.up_blocks):
        base = f"decoder.up_blocks.{i}"
        for j, res in enumerate(blk.resnets):
            x = resnet_block(res, f"{base}.resnets.{j}", x, state, new_state,
                             cq, lowering)
        if i < n_blocks - 1:
            x = _upsample3d(blk.upsamplers[0], f"{base}.upsamplers.0", x,
                            state, new_state, i < cfg.temporal_scale_num,
                            first_slice, lowering)
    x = norm_silu_conv(dec.conv_norm_out, dec.conv_out, "decoder.conv_out", x,
                       state, new_state, cq, lowering)
    return x.permute(0, 2, 3, 4, 1), (new_state or {})
