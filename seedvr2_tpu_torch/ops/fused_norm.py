"""SEEDVR2_FUSED_NORM=1: fused group norm + SiLU + causal head for the VAE
(kernel K12).

Port of seedvr2_tpu.ops.fused_norm. Before a causal 3x3x3 conv of a first
slice, the unfused path computes the per-frame group norm, the SiLU, and
then a concatenation that prepends the causal head (frame 0 twice). Here
the group norm's per-(b, t, group) moments are taken in one plain pass and
folded into A = inv_std * weight and B = bias - mean * inv_std * weight per
(b, c, t); one pass then writes silu(bf16(x * A + B)) with the head frames
in place, re-reading frame 0 for them, so the concatenation never
materializes.

The port's VAE runs NCDHW, and the kernel runs on that layout directly
(`norm_silu_head_ncdhw`, (B, C, T, H, W) -> (B, C, T + hp, H, W));
`norm_silu_head` keeps the JAX layout (B, T, H, W, C). On a CUDA tensor
they launch csrc/fused_norm.cu; on a CPU tensor they run the plain version.
"""

from types import SimpleNamespace

import torch

from . import _build


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


def norm_silu_head_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-6,
                         head_frames: int = 2) -> torch.Tensor:
    """Plain version of K12 on NCDHW x (B, C, T, H, W) -> (B, C, T + hp, H,
    W): y = x * A + B in fp32 rounded to x's dtype, then y * sigmoid(y) in
    fp32 rounded again; the head frames repeat frame 0."""
    a, bc = _fold(x, weight, bias, groups, eps)
    y = (x.float() * a[..., None, None] + bc[..., None, None]).to(x.dtype)
    y = y.float()
    y = (y * torch.sigmoid(y)).to(x.dtype)
    return torch.cat([y[:, :, :1].expand(-1, -1, head_frames, -1, -1), y],
                     dim=2)


def norm_silu_head_ncdhw(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-6,
                         head_frames: int = 2) -> torch.Tensor:
    """K12 on the VAE's layout: x (B, C, T, H, W) -> (B, C, T + hp, H, W).
    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise on what it does not take: contiguous bf16, 16-byte aligned."""
    if x.device.type == "cpu":
        return norm_silu_head_plain(x, weight, bias, groups, eps, head_frames)
    if x.device.type != "cuda":
        raise RuntimeError(f"norm_silu_head: no kernel for {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("norm_silu_head kernel: x must be contiguous, "
                         f"16-byte aligned bf16, got {x.dtype}")
    b, c, t, h, w = x.shape
    a, bc = _fold(x, weight, bias, groups, eps)
    out = torch.empty((b, c, t + head_frames, h, w), dtype=x.dtype,
                      device=x.device)
    err = _build.kernel_library().lib.seedvr2_norm_silu_head(
        x.data_ptr(), a.data_ptr(), bc.data_ptr(), out.data_ptr(), b, c, t,
        h * w, head_frames, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "seedvr2_norm_silu_head")
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
