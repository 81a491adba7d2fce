"""Elementwise / normalization / linear building blocks (plain torch).

Port of seedvr2_tpu.ops.layers, dense, w8a8, Q8_0 and affine branches.
Numerics follow the JAX package: fp32 statistics, products accumulated in
fp32 (or int32 for w8a8) and rounded once to the activation dtype, bias
added after the rounding. Under tensor parallelism (parallel/tp.py) a
row-sharded projection's partial product is summed over the tp ranks in
fp32 (`reduce`) before that one rounding, as the JAX package's psum_axis
does: rounding each partial to bf16 first loses mantissa bits per partial
and compounds per layer (~1% pixel error at 2 chips, JAX measured).
"""

from typing import Callable, Optional

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


Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


class _ProductF32(torch.autograd.Function):
    """x @ w^T of half-precision operands on a card with an fp32 output
    (cuBLAS's tensor-core GEMM through torch.mm's out_dtype), with its
    gradient: the incoming fp32 gradient, which holds the values of the
    rounded output's (bf16-exact), is taken in the operands' dtype for the
    two products of the backward, each summed in fp32 and rounded once."""

    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return torch.mm(x2d, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x2d, w = ctx.saved_tensors
        g = grad.to(x2d.dtype)
        dx = torch.mm(g, w) if ctx.needs_input_grad[0] else None
        dw = torch.mm(g.t(), x2d) if ctx.needs_input_grad[1] else None
        return dx, dw


def _matmul_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight^T summed in fp32 and left unrounded. Half-precision
    operands on a card go to cuBLAS's tensor-core GEMM with an fp32 output
    (torch.mm's out_dtype; `_ProductF32` when a gradient flows), as JAX's
    dot with preferred_element_type does; elsewhere the fp32 matmul of the
    widened operands (bf16 x bf16 products are exact in fp32)."""
    w = weight.to(x.dtype)
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        x2d = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _ProductF32.apply(x2d, w)
        else:
            out = torch.mm(x2d, w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.float(), w.float().t())


def linear(x, layer, use_kernels: bool = True,
           reduce: Reduce = None) -> torch.Tensor:
    """x @ W^T + b for an nn.Linear-shaped layer (weight (out, in)). The
    product accumulates in fp32 (cuBLAS and the CPU kernels both do), is
    rounded to x's dtype, and only then gets the bias, as in the JAX
    package.

    reduce: a row-sharded projection's tp sum (parallel/comm.tp_reducer):
    the local product is taken in fp32 (every layout's kernel writes fp32
    then: K3, K6, K7), summed by `reduce` (in place when serving; under
    autograd into a new tensor, its gradient passed back to each rank's
    partial), rounded once to x's dtype, and the replicated bias added
    once.

    A W8A8Linear serves the int8 lane (ops/int8_matmul.w8a8_linear, kernel
    K3 unless use_kernels is False); x may then be a PreQuantized from a
    fused producer. A Q8Linear runs kernel K6 and an AffineLinear kernel K7
    (ops/quant_matmul.py; their plain versions without use_kernels). A
    PreQuantized with any other layer raises TypeError."""
    if isinstance(layer, W8A8Linear):
        return w8a8_linear(x, layer, use_kernels, reduce)
    if isinstance(x, PreQuantized):
        raise TypeError("PreQuantized input requires w8a8 weights")
    if isinstance(layer, Q8Linear):
        return quant_linear(x, layer, use_kernels, reduce)
    if isinstance(layer, AffineLinear):
        return affine_quant_linear(x, layer, use_kernels, reduce)
    if reduce is not None:
        acc = reduce(_matmul_f32(x, layer.weight))
        out = acc.to(x.dtype)
    else:
        out = torch.matmul(x, layer.weight.to(x.dtype).t())
    if layer.bias is not None:
        out = out + layer.bias.to(x.dtype)
    return out


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def mlp_forward(x, mlp, mlp_type: str, use_kernels: bool = True,
                reduce: Reduce = None) -> torch.Tensor:
    """swiglu: proj_out(silu(proj_in_gate(x)) * proj_in(x)); normal:
    proj_out(gelu_tanh(proj_in(x))).

    w8a8 swiglu: gate and up run as one int8 GEMM
    (w8a8_double_linear), and a w8a8 proj_out takes silu(g) * u through
    the fused quantize (kernel K5, its plain version without use_kernels).
    x may be a PreQuantized there. Q8_0 and affine layers run each linear
    on its own, as the JAX package does. reduce: tensor parallelism, the
    proj_in* column-sharded (their biases with their columns) and proj_out
    row-sharded, summed by `reduce` (linear)."""
    if mlp_type == "swiglu":
        gate, up, out = mlp.proj_in_gate, mlp.proj_in, mlp.proj_out
        if isinstance(gate, W8A8Linear) and isinstance(up, W8A8Linear):
            g, u = w8a8_double_linear(x, gate, up, use_kernels)
            if isinstance(out, W8A8Linear):
                fused = (silu_mul_quantize if use_kernels
                         else silu_mul_quantize_plain)
                return linear(fused(g, u), out, use_kernels, reduce)
            return linear(silu(g) * u, out, use_kernels, reduce)
        return linear(silu(linear(x, gate, use_kernels))
                      * linear(x, up, use_kernels), out, use_kernels, reduce)
    return linear(gelu_tanh(linear(x, mlp.proj_in, use_kernels)),
                  mlp.proj_out, use_kernels, reduce)


def swiglu_hidden_dim(dim: int, expand_ratio: int, multiple_of: int = 256) -> int:
    hidden = int(2 * dim * expand_ratio / 3)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)
