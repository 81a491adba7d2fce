"""Elementwise / normalization / linear building blocks (plain torch).

Port of seedvr2_tpu.ops.layers, dense, w8a8, Q8_0 and affine branches.
Numerics follow the JAX package: fp32 statistics, products accumulated in
fp32 (or int32 for w8a8) and rounded once to the activation dtype, bias
added after the rounding.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from .fused_quant import (PreQuantized, silu_mul_quantize,
                          silu_mul_quantize_plain)
from .int8_matmul import W8A8Linear, w8a8_double_linear, w8a8_linear
from .quant_matmul import (AffineLinear, Q8Linear, affine_quant_linear,
                           quant_linear)


def rms_norm(x: torch.Tensor, eps: float = 1e-5,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def group_norm(x: torch.Tensor, num_groups: int, eps: float = 1e-6,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over channels-last input (B, *spatial, C): statistics per
    group over every non-batch axis, in fp32."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    x32 = x.float().reshape(b, -1, g, c // g)
    mean = torch.mean(x32, dim=(1, 3), keepdim=True)
    var = torch.var(x32, dim=(1, 3), keepdim=True, correction=0)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def linear(x, layer, use_kernels: bool = True) -> torch.Tensor:
    """x @ W^T + b for an nn.Linear-shaped layer (weight (out, in)). The
    product accumulates in fp32 (cuBLAS and the CPU kernels both do), is
    rounded to x's dtype, and only then gets the bias, as in the JAX
    package.

    A W8A8Linear serves the int8 lane (ops/int8_matmul.w8a8_linear, kernel
    K3 unless use_kernels is False); x may then be a PreQuantized from a
    fused producer. A Q8Linear runs kernel K6 and an AffineLinear kernel K7
    (ops/quant_matmul.py; their plain versions without use_kernels). A
    PreQuantized with any other layer raises TypeError."""
    if isinstance(layer, W8A8Linear):
        return w8a8_linear(x, layer, use_kernels)
    if isinstance(x, PreQuantized):
        raise TypeError("PreQuantized input requires w8a8 weights")
    if isinstance(layer, Q8Linear):
        return quant_linear(x, layer, use_kernels)
    if isinstance(layer, AffineLinear):
        return affine_quant_linear(x, layer, use_kernels)
    out = torch.matmul(x, layer.weight.to(x.dtype).t())
    if layer.bias is not None:
        out = out + layer.bias.to(x.dtype)
    return out


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def mlp_forward(x, mlp, mlp_type: str, use_kernels: bool = True
                ) -> torch.Tensor:
    """swiglu: proj_out(silu(proj_in_gate(x)) * proj_in(x)); normal:
    proj_out(gelu_tanh(proj_in(x))).

    w8a8 swiglu: gate and up run as one int8 GEMM
    (w8a8_double_linear), and a w8a8 proj_out takes silu(g) * u through
    the fused quantize (kernel K5, its plain version without use_kernels).
    x may be a PreQuantized there. Q8_0 and affine layers run each linear
    on its own, as the JAX package does."""
    if mlp_type == "swiglu":
        gate, up, out = mlp.proj_in_gate, mlp.proj_in, mlp.proj_out
        if isinstance(gate, W8A8Linear) and isinstance(up, W8A8Linear):
            g, u = w8a8_double_linear(x, gate, up, use_kernels)
            if isinstance(out, W8A8Linear):
                fused = (silu_mul_quantize if use_kernels
                         else silu_mul_quantize_plain)
                return linear(fused(g, u), out, use_kernels)
            return linear(silu(g) * u, out, use_kernels)
        return linear(silu(linear(x, gate, use_kernels))
                      * linear(x, up, use_kernels), out, use_kernels)
    return linear(gelu_tanh(linear(x, mlp.proj_in, use_kernels)),
                  mlp.proj_out, use_kernels)


def swiglu_hidden_dim(dim: int, expand_ratio: int, multiple_of: int = 256) -> int:
    hidden = int(2 * dim * expand_ratio / 3)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)
