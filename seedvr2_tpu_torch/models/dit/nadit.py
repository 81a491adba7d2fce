"""NaDiT denoiser, the 3B and the 7B families.

Port of seedvr2_tpu.models.dit.nadit. The window plan is host-side numpy
(`build_dit_plan`, equal to the JAX one); `upload_plan` puts its tables and
indices on the device once per plan. Two plans of the attention, as in the
JAX package:

 - grouped (`build_dit_plan(..., uniform=False)`, the path the runner
   serves): tokens stay in *window-major* order across the block stack;
   each block applies one composed permutation (kernel K2,
   `ops.gather.gather_rows`) and every window shape group is one packed
   attention call (kernel K1, `ops.flash_attention.packed_window_attention`).
 - uniform (`uniform=True`, reached through this API only): every window
   padded to one extent, so the partition is pad + reshape + permute of
   canonical-order tokens, and one attention call per block covers every
   window, each roped by its own deduplicated table and with its pad keys
   masked (kernel K9, `ops.flash_attention.flash_windowed_attention`).
   Tokens stay canonical; no gathers.
 - `NaDiT`'s state_dict keys are the reference checkpoint names
   (blocks.{i}.attn.proj_qkv.{vid,txt,all}.weight, ...), i.e. what
   seedvr2_tpu.core.export.to_torch_state_dict emits.

Served in bf16, or in the w8a8 lane after
`ops.int8_matmul.quantize_dit_w8a8`: its int8 linears run kernel K3, and the
video stream's norm + modulation producers fuse with the activation
quantization (kernel K4, `_norm_mod`), the swiglu's silu*up with it (K5,
`ops.layers.mlp_forward`). In the q8 / q4 / q4k lanes
(`ops.quant_matmul`, `core.loader`) the Q8_0 linears run K6 and the affine
ones K7; their producers stay plain, as in the JAX package.

Training (parallel/train.py) runs either plan's forward with grad on. On
the grouped plan K1 and K2 go through their autograd Functions
(`ops.flash_attention.packed_window_attention_grad`,
`ops.gather.gather_rows_grad`), whose backward is hand-written too; the
qk-norm weights reach K1 only through the folded tables, whose gradients
K1's backward returns. On the uniform plan K9 goes through its Function
(`ops.flash_attention.flash_windowed_attention_grad`, reached through
ops.attention.attention): its backward returns dq, dk and dv, the qk-norms
and the text rope having run as plain torch ops before the windows are
cut, and the per-window rope tables being plan constants. The trainer runs
each block through `nadit_forward`'s `run_block`, which binds the block's
weights just before it runs and holds its backward apart.

Tensor parallelism (parallel/tp.py): after `tp_shard_dit` a rank holds its
heads' slice of every qkv / proj_out and its hidden columns of every mlp;
`nadit_forward(..., tp=comm)` then runs the blocks on the local heads
(the attention kernels take the head count from the qkv width, as the JAX
package's tp_axis does) and sums each row-sharded projection's fp32
partials over the tp ranks with `comm` (ops/layers.linear). Under
autograd (the trainer) `comm.enter` marks what the local heads and hidden
columns read: the inputs of the column-sharded projections and the
qk-norm weights, which every head shares. Their gradients, each rank's
part, are summed over the tp ranks there; everything else outside the
sharded projections (norms, modulation tables, the out-projections'
biases) already gets the same gradient on every rank.

Replicated quirks of the released models: 3B blocks >= mm_layers share their
vid/txt weights ("all"); the 3B last block has no txt mlp/ada branch; the
output modulation `vid_out_ada` reuses the blocks' attn-layer emb slices.
The 7B family: vid and txt weights in every block, qk norms never shared, a
plain MLP with biases (gelu-tanh, `ops.layers.mlp_forward`), rope3d on the
video rows only, no output norm, and with `cfg.upscaler` the `emb_scale`
time embedding of a downscale factor.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.configs import DiTConfig
from ...ops.attention import (attention, packed_attention_sdpa,
                               resolve_attention_mode)
# K1 and K2 through their autograd Functions: the raw kernel wrappers when
# no input needs a gradient (serving), the kernels' backward otherwise
from ...ops.flash_attention import (packed_window_attention_grad,
                                    packed_window_attention_plain)
from ...ops.fused_quant import rms_ada_quantize, rms_ada_quantize_plain
from ...ops.gather import RowIndex, gather_rows_grad, gather_rows_plain
from ...ops.int8_matmul import W8A8Linear
from ...ops.layers import linear, mlp_forward, rms_norm, silu, swiglu_hidden_dim
from . import rope as rope_lib
from .windows import UniformPlan, build_layer_plan, build_uniform_plan

_LANE = 128  # window rows + text rows are padded to a multiple of this

# --------------------------------------------------------------------------
# Plans (host-side numpy, equal to the JAX package's)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RopedGroup:
    shape: Tuple[int, int, int]
    idx: np.ndarray        # (n, wlen) int32
    # extended rope tables (wlen + txt_len, head_dim) fp32, text rope baked
    cos: Optional[np.ndarray]
    sin: Optional[np.ndarray]


@dataclass(frozen=True)
class RopedLayerPlan:
    groups: Tuple[RopedGroup, ...]
    inv: np.ndarray        # canonical[c] = window_major[inv[c]]
    flat: np.ndarray       # window_major[j] = canonical[flat[j]]
    num_windows: int


@dataclass(frozen=True)
class UniformAttnPlan:
    """Uniform padded partition of one window method: all windows share one
    padded extent (windows.build_uniform_plan), pad slots are masked with
    `valid`, and per-window rope tables, deduplicated over the windows'
    boundary patterns, are picked by `ids`."""

    up: UniformPlan
    ids: np.ndarray     # (num_windows,) int32 -> unique table/mask id
    cos: np.ndarray     # (nU, wlen + txt_len, head_dim) fp32
    sin: np.ndarray
    valid: np.ndarray   # (nU, wlen + txt_len) bool


@dataclass(frozen=True)
class DiTPlan:
    """Static per-(T, H, W, txt_len) window geometry: the grouped plan
    (`layer_plans`, `transitions`) always, the uniform one (`uniform`) when
    asked for."""

    vid_shape: Tuple[int, int, int]   # pre-patch latent (T, H, W)
    grid: Tuple[int, int, int]        # post-patch token grid (Tp, Hp, Wp)
    txt_len: int
    layer_plans: Dict[str, RopedLayerPlan]
    transitions: Dict[Tuple[str, str], np.ndarray]
    txt_cos: Optional[np.ndarray] = None   # 3B text rope (txt_len, rope_dim)
    txt_sin: Optional[np.ndarray] = None
    uniform: Optional[Dict[str, UniformAttnPlan]] = None

    @property
    def seq_len(self) -> int:
        t, h, w = self.grid
        return t * h * w


def _window_table(cfg: DiTConfig, real_shape, txt_len: int):
    """(rlen, rot) cos/sin for one real window extent (identity if no rope)."""
    if cfg.rope_type == "mmrope3d":
        return rope_lib.mmrope3d_video_table(real_shape, txt_len, cfg.rope_dim)
    if cfg.rope_type == "rope3d_window":
        return rope_lib.rope3d_pixel_table(real_shape, cfg.rope_dim)
    rlen = int(np.prod(real_shape))
    return (np.ones((rlen, 0), np.float32), np.zeros((rlen, 0), np.float32))


def _build_uniform_attn_plan(cfg: DiTConfig, grid, txt_len: int,
                             method: str) -> UniformAttnPlan:
    up = build_uniform_plan(grid, cfg.window, method)
    key_to_id: Dict[tuple, int] = {}
    tabs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    ids = np.zeros(up.num_windows, np.int32)
    for wdx, info in enumerate(up.win_info):
        if info not in key_to_id:
            real_shape = (info[0][0], info[1][0], info[2][0])
            cr, sr = _window_table(cfg, real_shape, txt_len)
            ce, se = rope_lib.embed_window_table(
                cr, sr, up.wshape, info, cfg.head_dim, txt_len)
            valid = np.concatenate(
                [up.kv_valid[wdx], np.ones(txt_len, dtype=bool)])
            key_to_id[info] = len(tabs)
            tabs.append((ce, se, valid))
        ids[wdx] = key_to_id[info]
    return UniformAttnPlan(
        up=up, ids=ids,
        cos=np.stack([t[0] for t in tabs]),
        sin=np.stack([t[1] for t in tabs]),
        valid=np.stack([t[2] for t in tabs]),
    )


def build_dit_plan(cfg: DiTConfig, vid_shape: Tuple[int, int, int],
                   txt_len: int, uniform: bool = False) -> DiTPlan:
    """Plan the static window geometry for one (T, H, W, txt_len).
    uniform=True adds the uniform padded partition, which nadit_forward
    then runs instead of the grouped one."""
    T, H, W = vid_shape
    pt, ph, pw = cfg.patch_size
    if H % ph or W % pw:
        raise ValueError("latent H/W must be patch-divisible")
    Tp = (T + pt - 1) // pt if T % pt != 0 or pt == 1 else T // pt
    if pt == 1:
        Tp = T
    grid = (Tp, H // ph, W // pw)

    layer_plans = {}
    for method in ("window", "shifted_window"):
        base = build_layer_plan(grid, cfg.window, method)
        groups = []
        for g in base.groups:
            if cfg.rope_type == "mmrope3d":
                cos, sin = rope_lib.mmrope3d_video_table(
                    g.shape, txt_len, cfg.rope_dim)
            elif cfg.rope_type == "rope3d_window":
                cos, sin = rope_lib.rope3d_pixel_table(g.shape, cfg.rope_dim)
            else:
                cos = sin = None
            if cos is not None:
                # head_dim wide, plus rows for the appended text tokens; 3B
                # text rope is baked into those rows so video and text rotate
                # in one pass, 7B text rows stay identity
                wlen = cos.shape[0]
                cos, sin = rope_lib.extend_tables(cos, sin, cfg.head_dim,
                                                  extra_rows=txt_len)
                if cfg.rope_type == "mmrope3d" and txt_len > 0:
                    tc, ts = rope_lib.mmrope3d_text_table(txt_len,
                                                          cfg.rope_dim)
                    cos[wlen:wlen + txt_len, :tc.shape[1]] = tc
                    sin[wlen:wlen + txt_len, :ts.shape[1]] = ts
            groups.append(RopedGroup(shape=g.shape, idx=g.idx, cos=cos, sin=sin))
        flat = np.concatenate([g.idx.reshape(-1) for g in base.groups])
        layer_plans[method] = RopedLayerPlan(
            groups=tuple(groups), inv=base.inv, flat=flat.astype(np.int32),
            num_windows=base.num_windows)

    # composed order transitions: wm_b = wm_a[inv_a[flat_b]]
    transitions: Dict[Tuple[str, str], np.ndarray] = {}
    methods = ("window", "shifted_window")
    for m in methods:
        transitions[("canonical", m)] = layer_plans[m].flat
        transitions[(m, "canonical")] = layer_plans[m].inv
    for a in methods:
        for b in methods:
            if a != b:
                transitions[(a, b)] = layer_plans[a].inv[
                    layer_plans[b].flat].astype(np.int32)
    txt_cos = txt_sin = None
    if cfg.rope_type == "mmrope3d":
        txt_cos, txt_sin = rope_lib.mmrope3d_text_table(txt_len, cfg.rope_dim)
    uniform_plans = None
    if uniform:
        uniform_plans = {m: _build_uniform_attn_plan(cfg, grid, txt_len, m)
                         for m in methods}
    return DiTPlan(vid_shape=vid_shape, grid=grid, txt_len=txt_len,
                   layer_plans=layer_plans, transitions=transitions,
                   txt_cos=txt_cos, txt_sin=txt_sin, uniform=uniform_plans)


@dataclass
class DeviceGroup:
    """One window shape group with its lane-padded tables on the device."""

    n: int          # windows in the group
    wlen: int       # tokens per window
    skv: int        # wlen + txt_len
    sk_pad: int     # skv padded to a multiple of 128
    cos: torch.Tensor   # (sk_pad, head_dim) fp32, identity pad rows
    sin: torch.Tensor


@dataclass
class DeviceUniformPlan:
    """A UniformAttnPlan's tables and mask on the device."""

    up: UniformPlan
    ids: np.ndarray            # (num_windows,) int32 -> table/mask id
    cos: torch.Tensor          # (nU, wlen + txt_len, head_dim) fp32
    sin: torch.Tensor
    valid: torch.Tensor        # (nU, wlen + txt_len) bool
    _batch_ids: Dict[int, RowIndex] = field(default_factory=dict)

    def batch_ids(self, batch: int) -> RowIndex:
        """The ids of B batch rows of windows, batch-major (the JAX
        package's np.tile(ids, B)), uploaded once per batch size."""
        if batch not in self._batch_ids:
            self._batch_ids[batch] = RowIndex(np.tile(self.ids, batch),
                                              self.cos.device)
        return self._batch_ids[batch]


@dataclass
class DevicePlan:
    plan: DiTPlan
    groups: Dict[str, List[DeviceGroup]]
    transitions: Dict[Tuple[str, str], RowIndex]
    num_windows: Dict[str, int]
    txt_cos: Optional[torch.Tensor] = None
    txt_sin: Optional[torch.Tensor] = None
    uniform: Optional[Dict[str, DeviceUniformPlan]] = None


def upload_plan(plan: DiTPlan, cfg: DiTConfig, device) -> DevicePlan:
    """Put a plan's tables and indices on the device, once."""
    groups: Dict[str, List[DeviceGroup]] = {}
    for method, lp in plan.layer_plans.items():
        out = []
        for g in lp.groups:
            n, wlen = g.idx.shape
            skv = wlen + plan.txt_len
            sk_pad = skv + (-skv) % _LANE
            if g.cos is not None:
                cos = np.pad(g.cos, ((0, sk_pad - skv), (0, 0)),
                             constant_values=1.0)
                sin = np.pad(g.sin, ((0, sk_pad - skv), (0, 0)))
            else:
                cos = np.ones((sk_pad, cfg.head_dim), np.float32)
                sin = np.zeros((sk_pad, cfg.head_dim), np.float32)
            out.append(DeviceGroup(
                n=n, wlen=wlen, skv=skv, sk_pad=sk_pad,
                cos=torch.as_tensor(cos, device=device),
                sin=torch.as_tensor(sin, device=device)))
        groups[method] = out
    transitions = {k: RowIndex(v, device) for k, v in plan.transitions.items()}

    def dev(a):
        return None if a is None else torch.as_tensor(a, device=device)

    uniform = None
    if plan.uniform is not None:
        uniform = {m: DeviceUniformPlan(up=u.up, ids=u.ids, cos=dev(u.cos),
                                        sin=dev(u.sin), valid=dev(u.valid))
                   for m, u in plan.uniform.items()}
    return DevicePlan(plan=plan, groups=groups, transitions=transitions,
                      num_windows={m: lp.num_windows
                                   for m, lp in plan.layer_plans.items()},
                      txt_cos=dev(plan.txt_cos), txt_sin=dev(plan.txt_sin),
                      uniform=uniform)


# --------------------------------------------------------------------------
# Modules (state_dict keys = reference checkpoint names)
# --------------------------------------------------------------------------


class _Weight(nn.Module):
    def __init__(self, dim: int, **fk):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, **fk))


class _Ada(nn.Module):
    def __init__(self, dim: int, layers=("attn", "mlp"),
                 kinds=("shift", "scale", "gate"), **fk):
        super().__init__()
        for layer in layers:
            for kind in kinds:
                self.register_parameter(f"{layer}_{kind}",
                                        nn.Parameter(torch.empty(dim, **fk)))


class _Proj(nn.Module):
    def __init__(self, d_in: int, d_out: int, **fk):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out, **fk)


class _TimeEmbedding(nn.Module):
    def __init__(self, dim: int, emb_dim: int, **fk):
        super().__init__()
        self.proj_in = nn.Linear(256, dim, **fk)
        self.proj_hid = nn.Linear(dim, dim, **fk)
        self.proj_out = nn.Linear(dim, emb_dim, **fk)


class _MLP(nn.Module):
    """The 3B swiglu MLP (no biases), or the 7B "normal" one: proj_in
    D -> D * expand_ratio and proj_out back, both with bias."""

    def __init__(self, dim: int, cfg: DiTConfig, **fk):
        super().__init__()
        if cfg.mlp_type == "swiglu":
            hidden = swiglu_hidden_dim(dim, cfg.expand_ratio)
            self.proj_in_gate = nn.Linear(dim, hidden, bias=False, **fk)
            self.proj_in = nn.Linear(dim, hidden, bias=False, **fk)
            self.proj_out = nn.Linear(hidden, dim, bias=False, **fk)
        else:
            hidden = dim * cfg.expand_ratio
            self.proj_in = nn.Linear(dim, hidden, **fk)
            self.proj_out = nn.Linear(hidden, dim, **fk)


def _mm_branches(cfg: DiTConfig, i: int) -> List[str]:
    if cfg.block_shared(i):
        return ["all"]
    if cfg.block_vid_only(i):
        return ["vid"]
    return ["vid", "txt"]


class _Attn(nn.Module):
    def __init__(self, cfg: DiTConfig, i: int, **fk):
        super().__init__()
        D, inner = cfg.vid_dim, cfg.heads * cfg.head_dim
        branches = ["all"] if cfg.block_shared(i) else ["vid", "txt"]
        # 3B qk norms follow the qkv branches; 7B ones are never shared
        norm_branches = (branches if cfg.family == "dit_3b"
                         else ["vid", "txt"])
        self.proj_qkv = nn.ModuleDict({b: nn.Linear(D, 3 * inner,
                                                    bias=cfg.qk_bias, **fk)
                                       for b in branches})
        self.proj_out = nn.ModuleDict({b: nn.Linear(inner, D, **fk)
                                       for b in branches})
        self.norm_q = nn.ModuleDict({b: _Weight(cfg.head_dim, **fk)
                                     for b in norm_branches})
        self.norm_k = nn.ModuleDict({b: _Weight(cfg.head_dim, **fk)
                                     for b in norm_branches})


class _Block(nn.Module):
    def __init__(self, cfg: DiTConfig, i: int, **fk):
        super().__init__()
        branches = _mm_branches(cfg, i)
        self.attn = _Attn(cfg, i, **fk)
        self.mlp = nn.ModuleDict({b: _MLP(cfg.vid_dim, cfg, **fk)
                                  for b in branches})
        self.ada = nn.ModuleDict({b: _Ada(cfg.vid_dim, **fk) for b in branches})


class NaDiT(nn.Module):
    """Parameter container of the NaDiT denoiser; `nadit_forward` runs it."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        D = cfg.vid_dim
        patch = int(np.prod(cfg.patch_size))
        self.vid_in = _Proj(cfg.vid_in_channels * patch, D, **fk)
        self.emb_in = _TimeEmbedding(D, cfg.emb_dim, **fk)
        self.vid_out = _Proj(D, cfg.vid_out_channels * patch, **fk)
        self.txt_in = (nn.Linear(cfg.txt_in_dim, D, **fk)
                       if cfg.txt_in_dim and cfg.txt_in_dim != cfg.txt_dim
                       else None)
        # NaDiTUpscaler: a second time embedding of the downscale factor
        self.emb_scale = (_TimeEmbedding(D, cfg.emb_dim, **fk)
                          if cfg.upscaler else None)
        self.blocks = nn.ModuleList(_Block(cfg, i, **fk)
                                    for i in range(cfg.num_layers))
        if cfg.vid_out_norm:
            self.vid_out_norm = _Weight(D, **fk)
            self.vid_out_ada = _Ada(D, layers=("out",), kinds=("shift", "scale"),
                                    **fk)


@torch.no_grad()
def init_dit(cfg: DiTConfig, device, dtype=torch.bfloat16,
             generator: Optional[torch.Generator] = None) -> NaDiT:
    """Random NaDiT drawn directly on `device`, with the distributions of the
    JAX package's init_dit_params: linears U(+-1/sqrt(fan_in)) for weight and
    bias, qk/out norm weights 1, ada shift/gate N(0, 1/D) and ada scale
    N(0, 1/D) + 1, each drawn in fp32 and rounded to `dtype`. The draws
    run on the generator's device, so a model built in host memory from a
    card's generator holds the values one built on that card does."""
    with torch.device("meta"):
        model = NaDiT(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    D = cfg.vid_dim

    def draw(p, fill):
        dev = generator.device if generator is not None else p.device
        tmp = torch.empty(p.shape, dtype=torch.float32, device=dev)
        fill(tmp)
        p.copy_(tmp.to(p.dtype))

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            bound = 1.0 / np.sqrt(mod.in_features)
            for p in (mod.weight, mod.bias):
                if p is not None:
                    draw(p, lambda t: t.uniform_(-bound, bound,
                                                 generator=generator))
        elif isinstance(mod, _Weight):
            mod.weight.fill_(1.0)
        elif isinstance(mod, _Ada):
            for pname, p in mod.named_parameters(recurse=False):
                offset = 1.0 if pname.endswith("_scale") else 0.0
                draw(p, lambda t: t.normal_(generator=generator)
                     .div_(np.sqrt(D)).add_(offset))
    return model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _pick(branches: nn.ModuleDict, branch: str):
    """MMModule branch resolution: shared weights live under 'all'."""
    return branches["all"] if "all" in branches else branches[branch]


def _time_embedding(emb: _TimeEmbedding, timestep: torch.Tensor,
                    dtype, use_kernels: bool) -> torch.Tensor:
    """Sinusoidal(256) -> SiLU MLP -> (B, 6*D). emb = [sin | cos], no flip."""
    half = 128
    exponent = -np.log(10000.0) * np.arange(half, dtype=np.float32) / half
    freqs = torch.as_tensor(np.exp(exponent), device=timestep.device)
    arg = timestep.float()[:, None] * freqs[None, :]
    x = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1).to(dtype)
    x = silu(linear(x, emb.proj_in, use_kernels))
    x = silu(linear(x, emb.proj_hid, use_kernels))
    return linear(x, emb.proj_out, use_kernels)


def _ada_in(x, shift_a, scale_a, ada: _Ada, layer: str):
    scale_b = getattr(ada, f"{layer}_scale").to(x.dtype)
    shift_b = getattr(ada, f"{layer}_shift").to(x.dtype)
    return x * (scale_a[:, None, :].to(x.dtype) + scale_b) + (
        shift_a[:, None, :].to(x.dtype) + shift_b)


def _norm_mod(x, shift_a, scale_a, ada: _Ada, layer: str, eps: float,
              consumer=None, use_kernels: bool = True):
    """rms_norm + AdaSingle modulation, the producer of a video-stream
    matmul input. When the consuming projection is w8a8, the chain runs as
    ONE fused pass that also emits the per-row int8 quantization the matmul
    reads (kernel K4, ops.fused_quant.rms_ada_quantize): a PreQuantized.
    Scale and shift rows are summed with the tables in fp32 first, as the
    JAX package does."""
    if isinstance(consumer, W8A8Linear):
        scale = (scale_a.float()
                 + getattr(ada, f"{layer}_scale").float()[None]).contiguous()
        shift = (shift_a.float()
                 + getattr(ada, f"{layer}_shift").float()[None]).contiguous()
        fused = rms_ada_quantize if use_kernels else rms_ada_quantize_plain
        return fused(x, scale, shift, eps)
    return _ada_in(rms_norm(x, eps), shift_a, scale_a, ada, layer)


def _ada_out(x, gate_a, ada: _Ada, layer: str):
    gate_b = getattr(ada, f"{layer}_gate").to(x.dtype)
    return x * (gate_a[:, None, :].to(x.dtype) + gate_b)


def _tp_enter(tp):
    """The tp line's `enter` (parallel.comm.TPComm) of what the local heads
    and hidden columns read; the identity without tensor parallelism."""
    return (lambda x: x) if tp is None else tp.enter


def _fold_norm_tables(cos_e: torch.Tensor, sin_e: torch.Tensor, wq_v, wq_t,
                      wk_v, wk_t, wlen: int, skv: int):
    """Fold the qk-norm weights into per-row rope tables:
    rope(q * w) == q * (cos * w) + rot_half(q) * (sin * perm(w)) where perm
    swaps interleaved pairs. Video rows get the vid branch weight, text rows
    the txt branch weight; pad rows keep 1 (their keys are masked)."""
    rows, d = cos_e.shape

    def row_w(w_vid, w_txt):
        w = torch.ones((rows, d), dtype=torch.float32, device=cos_e.device)
        w[:wlen] = w_vid.float()
        w[wlen:skv] = w_txt.float()
        return w

    def perm(w):
        return w.reshape(rows, d // 2, 2).flip(-1).reshape(rows, d)

    wq = row_w(wq_v, wq_t)
    wk = row_w(wk_v, wk_t)
    return cos_e * wq, sin_e * perm(wq), cos_e * wk, sin_e * perm(wk)


def _window_attention(attn: _Attn, cfg: DiTConfig, xv, xt, dplan: DevicePlan,
                      method: str, use_kernels: bool, mode: str = "flash",
                      tp=None):
    """Joint windowed multi-modal attention for one block.

    xv: (B, L, D) video tokens in this layer's window-major order (every
    shape group is a contiguous slice), or their PreQuantized form in the
    w8a8 lane; xt: (B, Ltxt, D) text. Per group the
    packed qkv rows of its windows are joined with the packed text rows and
    the lane pad in one copy and handed to kernel K1 (mode "xla": to the
    SDPA lane, ops.attention.packed_attention_sdpa). Text output is the
    mean over all windows. tp: the tensor-parallel reduce; the heads are
    then this rank's (the qkv width's), proj_out's partials summed."""
    B = xv.shape[0]
    Dh = cfg.head_dim
    eps = cfg.norm_eps
    ltxt = dplan.plan.txt_len
    if mode == "xla":
        attend = packed_attention_sdpa
    else:
        attend = (packed_window_attention_grad if use_kernels
                  else packed_window_attention_plain)

    enter = _tp_enter(tp)
    qkv_v = linear(enter(xv), _pick(attn.proj_qkv, "vid"),
                   use_kernels)                        # (B, L, 3HD)
    qkv_t = linear(enter(xt), _pick(attn.proj_qkv, "txt"),
                   use_kernels)                        # (B, Lt, 3HD)
    # every head, or this rank's under tensor parallelism
    Hn = qkv_v.shape[-1] // (3 * Dh)
    wq_v = enter(_pick(attn.norm_q, "vid").weight)
    wk_v = enter(_pick(attn.norm_k, "vid").weight)
    wq_t = enter(_pick(attn.norm_q, "txt").weight)
    wk_t = enter(_pick(attn.norm_k, "txt").weight)

    vid_chunks = []
    txt_acc = torch.zeros((B, ltxt, Hn * Dh), dtype=torch.float32,
                          device=qkv_v.device)
    offset = 0
    for g in dplan.groups[method]:
        size = g.n * g.wlen
        win = qkv_v[:, offset:offset + size].reshape(B, g.n, g.wlen,
                                                      3 * Hn * Dh)
        offset += size
        parts = [win, qkv_t[:, None].expand(B, g.n, ltxt, 3 * Hn * Dh)]
        if g.sk_pad > g.skv:
            parts.append(win.new_zeros((B, g.n, g.sk_pad - g.skv,
                                        3 * Hn * Dh)))
        packed = torch.cat(parts, dim=2).reshape(B * g.n, g.sk_pad,
                                                 3 * Hn * Dh)
        cq, sq, ck, sk = _fold_norm_tables(g.cos, g.sin, wq_v, wq_t, wk_v,
                                           wk_t, g.wlen, g.skv)
        out = attend(packed, Hn, Dh, cq, sq, ck, sk, eps,
                     kv_len=g.skv).reshape(B, g.n, g.sk_pad, Hn * Dh)
        vid_chunks.append(out[:, :, :g.wlen].reshape(B, size, Hn * Dh))
        txt_acc = txt_acc + out[:, :, g.wlen:g.skv].float().sum(dim=1)

    vid_out = torch.cat(vid_chunks, dim=1)  # stays window-major
    txt_out = (txt_acc / dplan.num_windows[method]).to(xv.dtype)
    vid_out = linear(vid_out, _pick(attn.proj_out, "vid"), use_kernels, tp)
    txt_out = linear(txt_out, _pick(attn.proj_out, "txt"), use_kernels, tp)
    return vid_out, txt_out


def _to_windows(x: torch.Tensor, up: UniformPlan) -> torch.Tensor:
    """(B, L, D) canonical raster -> (B, num_windows, window_len, D) by pad +
    reshape + permute (layout copies only, no gathers)."""
    B, L, D = x.shape
    T, H, W = up.size
    (ft, bt), (fh, bh), (fw, bw) = up.pads
    nt, nh, nw = up.nwin
    wt, wh, ww = up.wshape
    x = F.pad(x.reshape(B, T, H, W, D), (0, 0, fw, bw, fh, bh, ft, bt))
    x = x.reshape(B, nt, wt, nh, wh, nw, ww, D).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, nt * nh * nw, wt * wh * ww, D)


def _from_windows(xw: torch.Tensor, up: UniformPlan) -> torch.Tensor:
    """Inverse of _to_windows (pad rows are cropped)."""
    B, _, _, D = xw.shape
    T, H, W = up.size
    (ft, _), (fh, _), (fw, _) = up.pads
    nt, nh, nw = up.nwin
    wt, wh, ww = up.wshape
    x = xw.reshape(B, nt, nh, nw, wt, wh, ww, D).permute(0, 1, 4, 2, 5, 3, 6, 7)
    x = x.reshape(B, nt * wt, nh * wh, nw * ww, D)
    return x[:, ft:ft + T, fh:fh + H, fw:fw + W].reshape(B, T * H * W, D)


def _window_attention_uniform(attn: _Attn, cfg: DiTConfig, xv, xt,
                              dplan: DevicePlan, uplan: DeviceUniformPlan,
                              use_kernels: bool, mode: str = "flash",
                              tp=None):
    """Joint windowed multi-modal attention over the uniform padded
    partition. xv: (B, L, D) video tokens in canonical order (or their
    PreQuantized form in the w8a8 lane); xt: (B, Ltxt, D) text.

    The qkv projections and qk-norms run on the unpadded tokens; q, k and v
    are cut into windows (pad + permute), each window joined by the text
    rows, and one attention call over every window row of the batch
    (kernel K9 through ops.attention.attention) ropes each window with the
    table its id picks and masks its pad keys (mode "xla": the dispatcher's
    SDPA lane). Pad query rows are cropped;
    the text output is the fp32 mean over the windows. tp: as
    _window_attention's."""
    B, L = xv.shape[0], xv.shape[1]
    Dh = cfg.head_dim
    up = uplan.up
    enter = _tp_enter(tp)

    def qkv(x, branch):
        out = linear(enter(x), _pick(attn.proj_qkv, branch), use_kernels)
        # the head count from the projection's width, as the JAX package
        # derives it (every weight layout has its own leaves)
        hn = out.shape[-1] // (3 * Dh)
        out = out.reshape(*x.shape[:-1], 3, hn, Dh)
        return out[..., 0, :, :], out[..., 1, :, :], out[..., 2, :, :]

    qv, kv, vv = qkv(xv, "vid")
    qt, kt, vt = qkv(xt, "txt")
    Hn = qv.shape[-2]
    eps = cfg.norm_eps
    qv = rms_norm(qv, eps, enter(_pick(attn.norm_q, "vid").weight))
    kv = rms_norm(kv, eps, enter(_pick(attn.norm_k, "vid").weight))
    qt = rms_norm(qt, eps, enter(_pick(attn.norm_q, "txt").weight))
    kt = rms_norm(kt, eps, enter(_pick(attn.norm_k, "txt").weight))
    if dplan.txt_cos is not None:  # 3B mmrope: the text is roped too
        qt = rope_lib.apply_rope(qt, dplan.txt_cos, dplan.txt_sin)
        kt = rope_lib.apply_rope(kt, dplan.txt_cos, dplan.txt_sin)

    nW, wlen, ltxt = up.num_windows, up.window_len, dplan.plan.txt_len

    def windowed_with_txt(x, txt):
        xw = _to_windows(x.reshape(B, L, Hn * Dh), up)
        xw = xw.reshape(B, nW, wlen, Hn, Dh)
        t = txt[:, None].expand(B, nW, ltxt, Hn, Dh)
        return torch.cat([xw, t], dim=2).reshape(B * nW, wlen + ltxt, Hn, Dh)

    out = attention(
        windowed_with_txt(qv, qt), windowed_with_txt(kv, kt),
        windowed_with_txt(vv, vt), rope_cos=uplan.cos, rope_sin=uplan.sin,
        table_ids=uplan.batch_ids(B), kv_valid=uplan.valid,
        use_kernels=use_kernels, mode=mode).reshape(B, nW, wlen + ltxt, Hn * Dh)

    vid_out = _from_windows(out[:, :, :wlen], up)
    # text coalesce: the mean over all windows
    txt_out = out[:, :, wlen:].float().mean(dim=1).to(out.dtype)
    vid_out = linear(vid_out, _pick(attn.proj_out, "vid"), use_kernels, tp)
    txt_out = linear(txt_out, _pick(attn.proj_out, "txt"), use_kernels, tp)
    return vid_out, txt_out


def _block_forward(blk: _Block, cfg: DiTConfig, i: int, xv, xt, emb_attn,
                   emb_mlp, dplan: DevicePlan, order: str, use_kernels: bool,
                   mode: str = "flash", tp=None):
    """One NaMMSRTransformerBlock. xv arrives in `order` token order and
    leaves in this layer's window-major order on the grouped plan, in
    canonical order on the uniform one (the order is returned third). tp:
    the tensor-parallel reduce of a tp-sharded block (nadit_forward)."""
    method = cfg.window_method(i)
    uplan = dplan.uniform[method] if dplan.uniform is not None else None
    if uplan is None and order != method:
        index = dplan.transitions[(order, method)]
        xv = (gather_rows_grad(xv, index) if use_kernels
              else gather_rows_plain(xv, index))
    vid_only = cfg.block_vid_only(i)
    eps = cfg.norm_eps

    sa_v, ss_v, sg_v = emb_attn[..., 0], emb_attn[..., 1], emb_attn[..., 2]
    ma_v, ms_v, mg_v = emb_mlp[..., 0], emb_mlp[..., 1], emb_mlp[..., 2]
    ada_v = _pick(blk.ada, "vid")
    ada_t = _pick(blk.ada, "txt") if not vid_only else None

    # the video producers fuse into the w8a8 quantize of their consumer
    hv = _norm_mod(xv, sa_v, ss_v, ada_v, "attn", eps,
                   _pick(blk.attn.proj_qkv, "vid"), use_kernels)
    ht = rms_norm(xt, eps)
    # 3B last layer: txt enters attention normed but unmodulated and leaves
    # ungated
    ht = _ada_in(ht, sa_v, ss_v, ada_t, "attn") if ada_t is not None else ht
    if uplan is not None:
        hv, ht = _window_attention_uniform(blk.attn, cfg, hv, ht, dplan,
                                           uplan, use_kernels, mode, tp)
    else:
        hv, ht = _window_attention(blk.attn, cfg, hv, ht, dplan, method,
                                   use_kernels, mode, tp)
    hv = _ada_out(hv, sg_v, ada_v, "attn")
    ht = _ada_out(ht, sg_v, ada_t, "attn") if ada_t is not None else ht
    xv = xv + hv
    xt = xt + ht

    mlp_v = _pick(blk.mlp, "vid")
    hv = _norm_mod(xv, ma_v, ms_v, ada_v, "mlp", eps,
                   getattr(mlp_v, "proj_in_gate", mlp_v.proj_in),
                   use_kernels)
    enter = _tp_enter(tp)
    hv = mlp_forward(enter(hv), mlp_v, cfg.mlp_type, use_kernels, tp)
    xv = xv + _ada_out(hv, mg_v, ada_v, "mlp")
    if not vid_only:
        ht2 = _ada_in(rms_norm(xt, eps), ma_v, ms_v, ada_t, "mlp")
        ht2 = mlp_forward(enter(ht2), _pick(blk.mlp, "txt"), cfg.mlp_type,
                          use_kernels, tp)
        xt = xt + _ada_out(ht2, mg_v, ada_t, "mlp")
    return xv, xt, ("canonical" if uplan is not None else method)


def patchify(vid: torch.Tensor, patch_size) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, Tp*Hp*Wp, t*h*w*C), channel order (t h w c)."""
    pt, ph, pw = patch_size
    B, T, H, W, C = vid.shape
    if pt > 1 and T % pt != 1:
        raise ValueError("temporal patching expects T % pt == 1")
    if pt > 1:
        vid = torch.cat([vid[:, :1].expand(B, pt - 1, H, W, C), vid], dim=1)
        T = vid.shape[1]
    Tp, Hp, Wp = T // pt, H // ph, W // pw
    x = vid.reshape(B, Tp, pt, Hp, ph, Wp, pw, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, Tp * Hp * Wp, pt * ph * pw * C)


def unpatchify(x: torch.Tensor, grid, patch_size, out_channels: int,
               orig_t: int) -> torch.Tensor:
    """(B, L, t*h*w*C) -> (B, T, H, W, C)."""
    pt, ph, pw = patch_size
    Tp, Hp, Wp = grid
    B = x.shape[0]
    x = x.reshape(B, Tp, Hp, Wp, pt, ph, pw, out_channels)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    x = x.reshape(B, Tp * pt, Hp * ph, Wp * pw, out_channels)
    if pt > 1:
        x = x[:, Tp * pt - orig_t:]
    return x


def nadit_forward(model: NaDiT, vid: torch.Tensor, txt: torch.Tensor,
                  timestep: torch.Tensor, dplan: DevicePlan,
                  use_kernels: bool = True,
                  downscale: Optional[torch.Tensor] = None,
                  blocks: Optional[Iterable[nn.Module]] = None,
                  attention_mode: str = "flash", tp=None,
                  run_block: Optional[Callable] = None) -> torch.Tensor:
    """Denoiser forward.

    Args:
        model: NaDiT parameters (random via init_dit, or a checkpoint).
        vid: (B, T, H, W, vid_in_channels) latent+condition, pre-patch dims.
        txt: (B, txt_len, txt_in_dim) text embeddings.
        timestep: (B,) diffusion timesteps.
        dplan: upload_plan(build_dit_plan(cfg, (T, H, W), txt_len), ...)
            runs the grouped plan (kernels K1, K2);
            upload_plan(build_dit_plan(..., uniform=True), ...) the uniform
            one (kernel K9), which tokens cross in canonical order.
        use_kernels: False runs the plain versions of the kernels (K1, K2
            or K9, and K3-K7 in the quantised lanes) on any device, the
            reference a kernel run is held against.
        downscale: (B,) downscale factor of the NaDiTUpscaler variant
            (`cfg.upscaler`): emb += emb_scale(downscale). The runner never
            passes one, as in the JAX package.
        blocks: where the transformer blocks come from, in order
            (default `model.blocks`); ops.offload.StreamedNaDiT passes a
            generator that yields each block once its weights are on the
            device.
        attention_mode: "flash" (the kernels K1 / K9) or "xla" (the SDPA
            lane, ops.attention), or an alias of either (the CLI's
            --attention_mode); the gathers (K2) run in both.
        tp: tensor parallelism, for a model whose blocks
            parallel.tp.tp_shard_dit sharded: the tp line's collectives
            (parallel.comm.tp_reducer's TPComm), whose call sums a
            row-sharded projection's fp32 partials over the tp ranks and
            whose `enter` marks the column-sharded inputs. Every tp rank
            calls the forward with the same inputs and gets the same
            output.
        run_block: how each block runs (default: in place);
            run_block(i, fn, x, xt, emb_attn, emb_mlp) -> (x, xt), where
            fn(x, xt, emb_attn, emb_mlp) runs block i's forward. The
            trainer (parallel/train.py) passes one that binds the block's
            weights first and holds its backward.

    Returns:
        (B, T, H, W, vid_out_channels) prediction (v_lerp velocity).
    """
    cfg = model.cfg
    mode = resolve_attention_mode(attention_mode)
    B, T = vid.shape[0], vid.shape[1]
    x = linear(patchify(vid, cfg.patch_size), model.vid_in.proj, use_kernels)
    xt = (linear(txt, model.txt_in, use_kernels)
          if model.txt_in is not None else txt)

    emb = _time_embedding(model.emb_in, timestep, x.dtype,
                          use_kernels)  # (B, 6D)
    if model.emb_scale is not None and downscale is not None:
        emb = emb + _time_embedding(model.emb_scale, downscale, x.dtype,
                                    use_kernels)
    emb_r = emb.reshape(B, cfg.vid_dim, 2, 3).float()
    emb_attn, emb_mlp = emb_r[..., 0, :], emb_r[..., 1, :]

    order = "canonical"
    for i, blk in enumerate(model.blocks if blocks is None else blocks):
        if run_block is None:
            x, xt, order = _block_forward(blk, cfg, i, x, xt, emb_attn,
                                          emb_mlp, dplan, order, use_kernels,
                                          mode, tp)
            continue
        x, xt = run_block(i, lambda *a, blk=blk, i=i, order=order:
                          _block_forward(blk, cfg, i, *a, dplan, order,
                                         use_kernels, mode, tp)[:2],
                          x, xt, emb_attn, emb_mlp)
        order = ("canonical" if dplan.uniform is not None
                 else cfg.window_method(i))
    if order != "canonical":
        index = dplan.transitions[(order, "canonical")]
        x = (gather_rows_grad(x, index) if use_kernels
             else gather_rows_plain(x, index))

    if cfg.vid_out_norm:
        x = rms_norm(x, cfg.norm_eps, model.vid_out_norm.weight)
        # the reference's cache collision: output modulation reuses the
        # blocks' attn-layer emb slices
        shift_a, scale_a = emb_attn[..., 0], emb_attn[..., 1]
        scale_b = model.vid_out_ada.out_scale.to(x.dtype)
        shift_b = model.vid_out_ada.out_shift.to(x.dtype)
        x = x * (scale_a[:, None, :].to(x.dtype) + scale_b) + (
            shift_a[:, None, :].to(x.dtype) + shift_b)

    x = linear(x, model.vid_out.proj, use_kernels)
    return unpatchify(x, dplan.plan.grid, cfg.patch_size,
                      cfg.vid_out_channels, T)
