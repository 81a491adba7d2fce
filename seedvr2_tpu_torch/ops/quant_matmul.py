"""Quantised-checkpoint lanes: Q8_0 and 4-bit affine weights served through
dequantizing GEMMs (kernels K6 and K7), the quantizers, the quantised
linears and the DiT conversions.

Port of seedvr2_tpu.ops.quant_matmul (without the tensor-parallel fp32
output). Weights keep one int8 per value and fp32 tables per 32-group along
K:

 - Q8_0 (`--quant q8`, GGUF Q8_0): w = q * s, q in [-127, 127];
 - affine (`--quant q4`, native GGUF Q4_K/Q5_K under `--quant q4k`):
   w = q * s - m, q in [0, 15] (PTQ) or [0, 31] (Q5_K).

Layout: the port stores a weight (N, K) = (out, in), K-contiguous, with its
tables (N, K/32): the GGUF's own order and the one `mma ... row.col` reads
(the JAX package stores (K, N) and (K/32, N)).

On a CUDA tensor `quant_matmul_q8` and `quant_matmul_affine` launch the
hand-written kernels of `csrc/quant_matmul.cu` (its header says what bounds
them and how they keep the fp32 arithmetic exact); on a CPU tensor they run
the plain versions, the JAX package's non-TPU emulation.
"""

from typing import Optional

import torch
from torch import nn

from . import _build

GROUP = 32


def _groups(w: torch.Tensor) -> torch.Tensor:
    n, k = w.shape
    if k % GROUP:
        raise ValueError(f"K={k} is not a multiple of {GROUP}")
    return w.float().reshape(n, k // GROUP, GROUP)


def quantize_q8(w: torch.Tensor):
    """(N, K) float weight -> (q int8 (N, K), scales fp32 (N, K/32)); GGUF
    Q8_0: scale = absmax / 127 per 32-group, q = round_half_even(w * 1/s).
    The JAX quantize_q8's arithmetic on its (K, N) transpose, bit for bit."""
    w32 = _groups(w)
    scales = torch.amax(torch.abs(w32), dim=2) / 127.0
    inv = torch.where(scales > 0, 1.0 / scales, torch.zeros_like(scales))
    q = torch.clamp(torch.round(w32 * inv[..., None]), -127, 127)
    return q.to(torch.int8).reshape(w.shape), scales


def dequantize_q8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 and (N, K/32) scales -> (N, K) fp32."""
    return (_groups(q) * scales[..., None]).reshape(q.shape)


def quantize_affine4(w: torch.Tensor):
    """(N, K) float weight -> 4-bit affine (q int8 (N, K) in [0, 15],
    s fp32 (N, K/32), m fp32 (N, K/32)) with w ~= q * s - m per 32-group:
    the layout native Q4_K lands in, so PTQ q4 serves through the same K7.
    The JAX quantize_affine4's arithmetic, bit for bit."""
    w32 = _groups(w)
    mn = torch.amin(w32, dim=2)
    mx = torch.amax(w32, dim=2)
    s = (mx - mn) / 15.0
    inv = torch.where(s > 0, 1.0 / s, torch.zeros_like(s))
    q = torch.clamp(torch.round((w32 - mn[..., None]) * inv[..., None]), 0, 15)
    return q.to(torch.int8).reshape(w.shape), s, -mn


def dequantize_affine(q: torch.Tensor, s: torch.Tensor,
                      m: torch.Tensor) -> torch.Tensor:
    """(N, K) quants and (N, K/32) tables -> (N, K) fp32 q * s - m."""
    return (_groups(q) * s[..., None] - m[..., None]).reshape(q.shape)


# ------------------------------------------------------------------ kernels


def quant_matmul_q8_plain(x: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: x (M, K) @ dequantized (N, K)^T in fp32, rounded
    to x's dtype."""
    return torch.matmul(x.float(), dequantize_q8(q, scales).t()).to(x.dtype)


def quant_matmul_affine_plain(x: torch.Tensor, q: torch.Tensor,
                              s: torch.Tensor, m: torch.Tensor
                              ) -> torch.Tensor:
    """Plain version of K7: x (M, K) @ (q * s - m)^T in fp32, rounded to x's
    dtype."""
    return torch.matmul(x.float(),
                        dequantize_affine(q, s, m).t()).to(x.dtype)


def _check(name: str, x: torch.Tensor, q: torch.Tensor, tables) -> None:
    m, k = x.shape
    n, k2 = q.shape
    if k != k2 or k % GROUP or any(t.shape != (n, k // GROUP)
                                   for t in tables):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} q "
                         f"{tuple(q.shape)} tables "
                         f"{[tuple(t.shape) for t in tables]} do not match "
                         f"(K % {GROUP} == 0)")


def _launch(name: str, fn: str, x, q, tables) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch on the
    current stream and raise on a launch error."""
    m, k = x.shape
    n = q.shape[0]
    for label, t, dt in (("x", x, torch.bfloat16), ("q", q, torch.int8),
                         *((f"table {i}", t, torch.float32)
                           for i, t in enumerate(tables))):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} kernel: {label} must be contiguous {dt} "
                             f"on {x.device}, got {t.dtype} on {t.device}")
    if n % 2 or x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{name} kernel: needs N % 2 == 0 (N={n}) and "
                         "16-byte aligned x and q")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m and n:
        err = getattr(_build.kernel_library().lib, fn)(
            x.data_ptr(), q.data_ptr(), *(t.data_ptr() for t in tables),
            out.data_ptr(), m, n, k,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, fn)
    return out


def quant_matmul_q8(x: torch.Tensor, q: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ (q (N, K) int8 * scales (N, K/32) per 32-group)^T ->
    (M, N) in x's dtype, fp32 accumulation.

    CPU tensors take the plain version. CUDA tensors launch K6, or raise on
    what it does not take: bf16 x, contiguous operands on one device,
    K % 32 == 0, N even."""
    _check("quant_matmul_q8", x, q, (scales,))
    if x.device.type == "cpu":
        return quant_matmul_q8_plain(x, q, scales)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul_q8: no kernel for {x.device}")
    out = _launch("quant_matmul_q8", "seedvr2_quant_matmul_q8", x, q,
                  (scales,))
    quant_matmul_q8.launches += 1
    return out


quant_matmul_q8.launches = 0


def quant_matmul_affine(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                        m: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ (q * s - m per 32-group)^T -> (M, N) in x's dtype; q
    (N, K) int8 raw quants, s and m (N, K/32) fp32. The min term is taken as
    group_sums(x) @ m, as in the JAX kernel.

    CPU tensors take the plain version; CUDA tensors launch K7 or raise (as
    quant_matmul_q8)."""
    _check("quant_matmul_affine", x, q, (s, m))
    if x.device.type == "cpu":
        return quant_matmul_affine_plain(x, q, s, m)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul_affine: no kernel for {x.device}")
    out = _launch("quant_matmul_affine", "seedvr2_quant_matmul_affine", x, q,
                  (s, m))
    quant_matmul_affine.launches += 1
    return out


quant_matmul_affine.launches = 0


# ------------------------------------------------------------------ linears


class Q8Linear(nn.Module):
    """A Q8_0 linear: int8 weight `q8` (N, K), fp32 `scales` (N, K/32), and
    the float bias of the linear it replaced (or none). Buffers, not
    parameters: nothing here is trained. State-dict keys are the JAX tree's
    leaf names (<layer>.q8, .scales, .bias)."""

    def __init__(self, q8: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def in_features(self) -> int:
        return self.q8.shape[1]

    @property
    def out_features(self) -> int:
        return self.q8.shape[0]

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Q8Linear":
        q, s = quantize_q8(lin.weight.detach())
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(q, s, bias)

    @classmethod
    def empty_like(cls, lin: nn.Linear) -> "Q8Linear":
        """Uninitialised buffers of `lin`'s shapes, on its device, to be
        filled by load_state_dict."""
        n, k = lin.weight.shape
        dev = lin.weight.device
        bias = None if lin.bias is None else torch.empty_like(lin.bias)
        return cls(torch.empty((n, k), dtype=torch.int8, device=dev),
                   torch.empty((n, k // GROUP), device=dev), bias)


class AffineLinear(nn.Module):
    """A 4-bit affine linear (PTQ q4, native Q4_K/Q5_K): raw quants `qa`
    (N, K) int8, fp32 `s` and `m` (N, K/32), w = qa * s - m per group, and
    the float bias (or none). Keys <layer>.qa, .s, .m, .bias."""

    def __init__(self, qa: torch.Tensor, s: torch.Tensor, m: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("qa", qa)
        self.register_buffer("s", s)
        self.register_buffer("m", m)
        self.register_buffer("bias", bias)

    @property
    def in_features(self) -> int:
        return self.qa.shape[1]

    @property
    def out_features(self) -> int:
        return self.qa.shape[0]

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "AffineLinear":
        qa, s, m = quantize_affine4(lin.weight.detach())
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(qa, s, m, bias)

    @classmethod
    def empty_like(cls, lin: nn.Linear) -> "AffineLinear":
        n, k = lin.weight.shape
        dev = lin.weight.device
        bias = None if lin.bias is None else torch.empty_like(lin.bias)
        return cls(torch.empty((n, k), dtype=torch.int8, device=dev),
                   torch.empty((n, k // GROUP), device=dev),
                   torch.empty((n, k // GROUP), device=dev), bias)


def _finish(out: torch.Tensor, lead, bias) -> torch.Tensor:
    """(M, N) product -> (*lead, N), then the bias in the output dtype."""
    out = out.reshape(*lead, -1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def quant_linear(x: torch.Tensor, layer: Q8Linear,
                 use_kernels: bool = True) -> torch.Tensor:
    """linear() for a Q8Linear: the product rounded to x's dtype, then the
    bias. x: (..., K)."""
    mm = quant_matmul_q8 if use_kernels else quant_matmul_q8_plain
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return _finish(mm(x2, layer.q8, layer.scales), x.shape[:-1], layer.bias)


def affine_quant_linear(x: torch.Tensor, layer: AffineLinear,
                        use_kernels: bool = True) -> torch.Tensor:
    """linear() for an AffineLinear (as quant_linear)."""
    mm = quant_matmul_affine if use_kernels else quant_matmul_affine_plain
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return _finish(mm(x2, layer.qa, layer.s, layer.m), x.shape[:-1],
                   layer.bias)


# --------------------------------------------------------------- conversion


def _convert(model: nn.Module, cls, min_dim: int) -> nn.Module:
    targets = [name for name, mod in model.named_modules()
               if isinstance(mod, nn.Linear)
               and min(mod.in_features, mod.out_features) >= min_dim
               and mod.in_features % GROUP == 0]
    for name in targets:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, attr, cls.from_linear(getattr(parent, attr)))
    return model


def quantize_dit_q8(model: nn.Module, min_dim: int = 1024) -> nn.Module:
    """Post-training Q8_0 conversion in place, the counterpart of the JAX
    package's quantize_dit_params: every nn.Linear with min(K, N) >= min_dim
    and K % 32 == 0 becomes a Q8Linear (no N alignment); smaller and IO
    projections stay dense. Layers convert one at a time on their own
    device, so peak memory stays near the float model's. Returns the model."""
    return _convert(model, Q8Linear, min_dim)


def quantize_dit_affine4(model: nn.Module, min_dim: int = 1024) -> nn.Module:
    """Post-training 4-bit affine conversion in place (the JAX
    quantize_dit_params_affine4), with quantize_dit_q8's rule."""
    return _convert(model, AffineLinear, min_dim)
