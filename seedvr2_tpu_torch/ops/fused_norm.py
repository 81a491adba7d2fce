"""SEEDVR2_FUSED_NORM=1: fused group norm + SiLU + causal head for the VAE
(kernel K12).

Port of seedvr2_tpu.ops.fused_norm. Before a causal 3x3x3 conv of a first
slice, the unfused path computes the per-frame group norm, the SiLU, and
then a concatenation that prepends the causal head (frame 0 twice). Here
the group norm's per-(b, t, group) moments are folded into A = inv_std *
weight and B = bias - mean * inv_std * weight per (b, c, t); one pass then
writes silu(bf16(x * A + B)) with the head frames in place, re-reading
frame 0 for them, so the concatenation never materializes.

The port's VAE runs NCDHW, and the kernels run on that layout directly
(`norm_silu_head_ncdhw`, (B, C, T, H, W) -> (B, C, T + hp, H, W));
`norm_silu_head` keeps the JAX layout (B, T, H, W, C). On a CUDA tensor
they launch csrc/fused_norm.cu's two kernels, the moments (`norm_moments`,
which also folds) and the apply pass (`norm_silu_apply`), cut as
`plan_k12` says; on a CPU tensor they run the plain version.
"""

from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

# values of one plane a block reads: 64 KB of bf16 x for the moments, 16 KB
# for the apply pass (whose blocks also write; measured fastest on the H100)
K12_PIECE, K12_APPLY_PIECE = 32768, 8192
# the fold's threads: one a channel of a group
K12_MAX_GROUP_CHANNELS = 256


class K12Plan(NamedTuple):
    """How K12's kernels cut x (B, C, T, H, W) into pieces of its (b, c, t)
    planes of H * W values; every piece length is a multiple of 8."""

    pieces: int          # moments: pieces a plane
    piece: int
    apply_pieces: int    # apply: pieces a plane
    apply_piece: int
    parts: int           # moments partials a (b, t, group): C/G * pieces
    moments_blocks: int
    apply_blocks: int


def _split(hw: int, target: int):
    """(n, length): n pieces of `length` values cover hw, the last one
    shorter. `length` is `target` (a multiple of 8), so that in a 16-byte
    aligned plane every piece starts at a multiple of its own size (evenly
    split pieces that cut cache lines measured slower), or hw rounded up to
    8 when that is shorter."""
    length = min(target, -(-hw // 8) * 8)
    return -(-hw // length), length


def plan_k12(shape, groups: int) -> K12Plan:
    """K12's pieces of x (B, C, T, H, W): the moments' of K12_PIECE values,
    the apply pass's of K12_APPLY_PIECE (shorter planes in one piece).
    Raises on a grouping the moments kernel does not take."""
    b, c, t, h, w = shape
    if groups <= 0 or c % groups or c // groups > K12_MAX_GROUP_CHANNELS:
        raise ValueError(f"norm_silu_head kernel: {c} channels in {groups} "
                         f"groups (at most {K12_MAX_GROUP_CHANNELS} a group)")
    hw = h * w
    pieces, piece = _split(hw, K12_PIECE)
    apply_pieces, apply_piece = _split(hw, K12_APPLY_PIECE)
    parts = c // groups * pieces
    return K12Plan(pieces, piece, apply_pieces, apply_piece, parts,
                   b * t * groups * parts, b * c * t * apply_pieces)


def _fold(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          groups: int, eps: float):
    """Per-(b, t, group) fp32 moments of x (B, C, T, H, W), folded with the
    norm's weight and bias into (A, B) (B, C, T) fp32, in the JAX order."""
    b, c, t, h, w = x.shape
    g = groups
    xr = x.reshape(b, g, c // g, t, h * w)
    n = (c // g) * h * w
    mean = xr.mean(dim=(2, 4), dtype=torch.float32)          # (b, g, t)
    meansq = torch.linalg.vector_norm(xr, 2, dim=(2, 4),
                                      dtype=torch.float32).square() / n
    var = torch.clamp_min(meansq - mean.square(), 0.0)
    inv = torch.rsqrt(var + eps)[:, :, None]                 # (b, g, 1, t)
    mean = mean[:, :, None]
    w32 = weight.float().view(1, g, c // g, 1)
    b32 = bias.float().view(1, g, c // g, 1)
    a = inv * w32
    bc = b32 - mean * inv * w32
    return a.reshape(b, c, t).contiguous(), bc.reshape(b, c, t).contiguous()


def fold_from_sums(s: torch.Tensor, s2: torch.Tensor, n: int,
                   weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """The moments kernel's fold, from the fp32 sums of x and x^2 of each
    (b, group, t) (s, s2: (B, G, T)) over its n values: mean = s / n,
    inv = rsqrt(max(s2 / n - mean^2, 0) + eps), A = inv * w and
    Bc = b - (mean * inv) * w, each (B, C, T) fp32."""
    b, g, t = s.shape
    mean = s / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)[:, :, None]                 # (b, g, 1, t)
    mean = mean[:, :, None]
    w32 = weight.float().view(1, g, -1, 1)
    b32 = bias.float().view(1, g, -1, 1)
    a = inv * w32
    bc = b32 - (mean * inv) * w32
    return a.reshape(b, -1, t).contiguous(), bc.reshape(b, -1, t).contiguous()


def norm_moments_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, groups: int, eps: float = 1e-6):
    """Plain version of the moments kernel: the fp32 sums of x and x^2 of
    each piece of `plan_k12`, combined per (b, t, group) in the kernel's
    partial order (channel-major, then piece), then `fold_from_sums`.
    Returns (A, Bc) (B, C, T) fp32."""
    b, c, t, h, w = x.shape
    plan = plan_k12(x.shape, groups)
    xf = F.pad(x.float().reshape(b, c, t, h * w),
               (0, plan.pieces * plan.piece - h * w))
    xf = xf.reshape(b, c, t, plan.pieces, plan.piece)

    def by_group(v):  # (b, c, t, pieces) -> (b, g, t), parts in order
        v = v.reshape(b, groups, c // groups, t, plan.pieces)
        return v.permute(0, 1, 3, 2, 4).reshape(b, groups, t, -1).sum(-1)

    return fold_from_sums(by_group(xf.sum(-1)), by_group((xf * xf).sum(-1)),
                          c // groups * h * w, weight, bias, eps)


def norm_silu_apply_plain(x: torch.Tensor, a: torch.Tensor, bc: torch.Tensor,
                          head_frames: int = 2) -> torch.Tensor:
    """Plain version of the apply kernel on x (B, C, T, H, W) with A, Bc
    (B, C, T): y = x * A + Bc in fp32 rounded to x's dtype, then
    y * sigmoid(y) in fp32 rounded again; the head frames repeat frame 0."""
    y = (x.float() * a[..., None, None] + bc[..., None, None]).to(x.dtype)
    y = y.float()
    y = (y * torch.sigmoid(y)).to(x.dtype)
    return torch.cat([y[:, :, :1].expand(-1, -1, head_frames, -1, -1), y],
                     dim=2)


def norm_silu_head_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-6,
                         head_frames: int = 2) -> torch.Tensor:
    """Plain version of K12 on NCDHW x (B, C, T, H, W) -> (B, C, T + hp, H,
    W): the JAX order's moments (`_fold`), then `norm_silu_apply_plain`."""
    return norm_silu_apply_plain(x, *_fold(x, weight, bias, groups, eps),
                                 head_frames)


def _kernel_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"norm_silu_head: no kernel for {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("norm_silu_head kernel: x must be contiguous, "
                         f"16-byte aligned bf16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"norm_silu_head kernel: x (B, C, T, H, W), got "
                         f"{tuple(x.shape)}")


# per device: the moments kernel's group counters, zeroed once; each
# group's last block returns its counter to 0, so launches on one stream
# reuse them
_COUNTERS = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _moments_kernel(x, weight, bias, groups, eps, plan):
    b, c, t, h, w = x.shape
    if (weight.shape != (c,) or bias.shape != (c,)
            or weight.dtype != bias.dtype
            or weight.dtype not in (torch.float32, torch.bfloat16)
            or not weight.is_contiguous() or not bias.is_contiguous()
            or weight.device != x.device or bias.device != x.device):
        raise ValueError("norm_silu_head kernel: weight and bias must be "
                         f"contiguous ({c},) fp32 or bf16 on {x.device}, got "
                         f"{tuple(weight.shape)} {weight.dtype}, "
                         f"{tuple(bias.shape)} {bias.dtype}")
    a = torch.empty((b, c, t), dtype=torch.float32, device=x.device)
    bc = torch.empty_like(a)
    part = torch.empty(b * t * groups * plan.parts * 2, dtype=torch.float32,
                       device=x.device)
    err = _build.kernel_library().lib.seedvr2_k12_moments(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        int(weight.dtype == torch.bfloat16), part.data_ptr(),
        _counters(x.device, b * t * groups).data_ptr(), a.data_ptr(),
        bc.data_ptr(), b, c, t, groups, h * w, plan.pieces, plan.piece,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "seedvr2_k12_moments")
    return a, bc


def _apply_kernel(x, a, bc, head_frames, plan):
    b, c, t, h, w = x.shape
    for name, v in (("A", a), ("Bc", bc)):
        if (v.shape != (b, c, t) or v.dtype != torch.float32
                or not v.is_contiguous() or v.device != x.device):
            raise ValueError(f"norm_silu_apply kernel: {name} must be "
                             f"contiguous fp32 {(b, c, t)} on {x.device}, "
                             f"got {tuple(v.shape)} {v.dtype}")
    out = torch.empty((b, c, t + head_frames, h, w), dtype=x.dtype,
                      device=x.device)
    if head_frames < 0:
        raise ValueError(f"norm_silu_apply: head_frames {head_frames} < 0")
    err = _build.kernel_library().lib.seedvr2_k12_apply(
        x.data_ptr(), a.data_ptr(), bc.data_ptr(), out.data_ptr(), b, c, t,
        h * w, head_frames, plan.apply_pieces, plan.apply_piece,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "seedvr2_k12_apply")
    return out


def norm_moments(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 groups: int, eps: float = 1e-6):
    """K12's first kernel: the group moments of x (B, C, T, H, W) folded
    into (A, Bc) (B, C, T) fp32. CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise on what it does not take."""
    if x.device.type == "cpu":
        return norm_moments_plain(x, weight, bias, groups, eps)
    _kernel_x(x)
    return _moments_kernel(x, weight, bias, groups, eps,
                           plan_k12(x.shape, groups))


def norm_silu_apply(x: torch.Tensor, a: torch.Tensor, bc: torch.Tensor,
                    head_frames: int = 2) -> torch.Tensor:
    """K12's second kernel: silu(bf16(x * A + Bc)) with the head frames,
    (B, C, T, H, W) -> (B, C, T + hp, H, W). CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise."""
    if x.device.type == "cpu":
        return norm_silu_apply_plain(x, a, bc, head_frames)
    _kernel_x(x)
    return _apply_kernel(x, a, bc, head_frames,
                         plan_k12(x.shape, x.shape[1]))  # groups unused


def norm_silu_head_ncdhw(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-6,
                         head_frames: int = 2) -> torch.Tensor:
    """K12 on the VAE's layout: x (B, C, T, H, W) -> (B, C, T + hp, H, W).
    CPU tensors take the plain version; CUDA tensors launch the moments and
    the apply kernel, or raise on what they do not take: contiguous bf16,
    16-byte aligned, at most 256 channels a group."""
    if x.device.type == "cpu":
        return norm_silu_head_plain(x, weight, bias, groups, eps, head_frames)
    _kernel_x(x)
    plan = plan_k12(x.shape, groups)
    a, bc = _moments_kernel(x, weight, bias, groups, eps, plan)
    out = _apply_kernel(x, a, bc, head_frames, plan)
    norm_silu_head.launches += 1
    return out


def norm_silu_head(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-6,
                   head_frames: int = 2) -> torch.Tensor:
    """The JAX layout: x (B, T, H, W, C) -> (B, T + hp, H, W, C), the first
    hp frames the processed frame 0 (the causal head of a first slice), the
    rest silu(groupnorm_per_frame(x))."""
    out = norm_silu_head_ncdhw(x.permute(0, 4, 1, 2, 3).contiguous(), weight,
                               bias, groups, eps, head_frames)
    return out.permute(0, 2, 3, 4, 1)


norm_silu_head.launches = 0


def norm_silu_head_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, groups: int,
                             eps: float = 1e-6,
                             head_frames: int = 2) -> torch.Tensor:
    """The unfused composition K12 replaces, in the JAX layout: per-frame
    group norm -> SiLU -> the head frames prepended."""
    from ..models.vae.model import frame_group_norm

    norm = SimpleNamespace(num_groups=groups, weight=weight, bias=bias)
    y = torch.nn.functional.silu(
        frame_group_norm(norm, x.permute(0, 4, 1, 2, 3), eps))
    y = torch.cat([y[:, :, :1].expand(-1, -1, head_frames, -1, -1), y], dim=2)
    return y.permute(0, 2, 3, 4, 1)
