"""w8a8 serving lane: int8 x int8 -> int32 GEMM (kernel K3), the
quantization helpers, the w8a8 linears and the DiT conversion.

Port of seedvr2_tpu.ops.int8_matmul (without tensor parallelism):
weights are quantized per output channel once, activations per row at run
time, and

    out[m, n] = bf16((float(sum_k xq[m, k] * wq[n, k]) * xs[m]) * ws[n])

Layout: the port stores a weight (N, K), K-contiguous (the JAX package
stores (K, N)), the layout `mma ... row.col` reads; activations are (M, K).

On a CUDA tensor `int8_matmul` launches the hand-written kernel
`csrc/int8_matmul.cu` (its header says what bounds it and how it is laid
out); on a CPU tensor it runs the plain version.
"""

from typing import Optional

import torch
from torch import nn

from . import _build
from .fused_quant import PreQuantized
from .quant_matmul import Q8Linear, dequantize_q8


def quantize_activations(x: torch.Tensor):
    """Per-row symmetric int8: (..., K) -> ((..., K) int8, (...,) fp32)."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(-1)


def quantize_weight_w8a8(w: torch.Tensor):
    """(N, K) float weight -> ((N, K) int8, (N,) fp32 per-channel scales).
    The same arithmetic as the JAX package's quantize_weight_w8a8 on its
    (K, N) transpose, on whatever device w lives."""
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                      ws: torch.Tensor, out_dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """Plain version of K3. CUDA has no integer matmul, so the product is
    taken in float64, which is exact here (|acc| <= 127^2 * K < 2^53), and
    converted to fp32 as an int32 would be (round to nearest even)."""
    acc = torch.matmul(xq.double(), wq.double().t()).float()
    return (acc * xs.float()[:, None] * ws.float()[None, :]).to(out_dtype)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                ws: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq (M, K) int8 @ wq (N, K) int8 -> (M, N), scaled by xs (M,) and
    ws (N,) fp32.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise on what it does not take: contiguous operands on one device,
    bf16 output, K % 32 == 0, K > 0, N % 8 == 0."""
    m, k = xq.shape
    n, k2 = wq.shape
    if k != k2 or xs.shape != (m,) or ws.shape != (n,):
        raise ValueError(f"int8_matmul: shapes {tuple(xq.shape)} "
                         f"{tuple(wq.shape)} {tuple(xs.shape)} "
                         f"{tuple(ws.shape)} do not match")
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, wq, xs, ws, out_dtype)
    if xq.device.type != "cuda":
        raise RuntimeError(f"int8_matmul: no kernel for {xq.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"int8_matmul kernel writes bf16, not {out_dtype}")
    for name, t, dt in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                        ("xs", xs, torch.float32), ("ws", ws, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != xq.device:
            raise ValueError(f"int8_matmul kernel: {name} must be contiguous "
                             f"{dt} on {xq.device}, got {t.dtype} on "
                             f"{t.device}")
    if k == 0 or k % 32 or n % 8 or xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"int8_matmul kernel: needs K % 32 == 0 (K={k}), "
                         f"N % 8 == 0 (N={n}) and 16-byte aligned operands")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    if m:
        err = _build.kernel_library().lib.seedvr2_int8_matmul(
            xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, n, k,
            torch.cuda.current_stream(xq.device).cuda_stream)
        _build.check(err, "seedvr2_int8_matmul")
        int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


class W8A8Linear(nn.Module):
    """A w8a8 linear: int8 weight (N, K), fp32 per-channel scales (N,), and
    the float bias of the linear it replaced (or none). Buffers, not
    parameters: nothing here is trained."""

    def __init__(self, w8a8: torch.Tensor, ws: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w8a8", w8a8)
        self.register_buffer("ws", ws)
        self.register_buffer("bias", bias)

    @property
    def out_features(self) -> int:
        return self.w8a8.shape[0]

    @classmethod
    def from_linear(cls, lin: nn.Module) -> "W8A8Linear":
        """From an nn.Linear, or a Q8Linear dequantized to fp32 first (the
        Q8_0 block scales folded in before the per-channel quantization)."""
        w = (dequantize_q8(lin.q8, lin.scales) if isinstance(lin, Q8Linear)
             else lin.weight.detach())
        q, s = quantize_weight_w8a8(w)
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(q, s, bias)


def _product(x, wq: torch.Tensor, ws: torch.Tensor, use_kernels: bool):
    """x (float tensor or PreQuantized) @ wq^T with scales, as (lead, N) in
    x's dtype; float inputs are quantized per row first."""
    if isinstance(x, PreQuantized):
        q, s, dtype = x.q, x.s, x.dtype
    else:
        (q, s), dtype = quantize_activations(x), x.dtype
    lead, k = q.shape[:-1], q.shape[-1]
    matmul = int8_matmul if use_kernels else int8_matmul_plain
    out = matmul(q.reshape(-1, k), wq, s.reshape(-1), ws, out_dtype=dtype)
    return out.reshape(*lead, wq.shape[0])


def w8a8_linear(x, layer: W8A8Linear, use_kernels: bool = True
                ) -> torch.Tensor:
    """Drop-in linear: x quantized per row (or a PreQuantized from a fused
    producer), int8 GEMM, then the bias in the output dtype."""
    out = _product(x, layer.w8a8, layer.ws, use_kernels)
    if layer.bias is not None:
        out = out + layer.bias.to(out.dtype)
    return out


def fuse_gate_up(a: W8A8Linear, b: W8A8Linear) -> None:
    """Lay two w8a8 linears that share an input (swiglu gate and up) out as
    the halves of one (Na+Nb, K) weight and scale vector, kept on `a`, so
    w8a8_double_linear runs them as one GEMM without a per-call concat. The
    two layers' buffers become views of the joint ones (non-persistent, so
    the state dict keeps its per-layer keys): loading a state dict into them
    fills the joint buffers too."""
    na = a.out_features
    a.register_buffer("gate_up_w8a8", torch.cat([a.w8a8, b.w8a8]),
                      persistent=False)
    a.register_buffer("gate_up_ws", torch.cat([a.ws, b.ws]), persistent=False)
    a.w8a8, b.w8a8 = a.gate_up_w8a8[:na], a.gate_up_w8a8[na:]
    a.ws, b.ws = a.gate_up_ws[:na], a.gate_up_ws[na:]


def w8a8_double_linear(x, a: W8A8Linear, b: W8A8Linear,
                       use_kernels: bool = True):
    """Two w8a8 linears sharing one input (swiglu gate + up): one activation
    quantization and ONE (M, Na+Nb) GEMM over the joint weight laid out by
    fuse_gate_up. Returns the two halves (views) with their biases."""
    if getattr(a, "gate_up_w8a8", None) is None:
        raise ValueError("w8a8_double_linear: the pair is not joined; "
                         "quantize_dit_w8a8 (or fuse_gate_up) joins it")
    out = _product(x, a.gate_up_w8a8, a.gate_up_ws, use_kernels)
    na = a.out_features
    ga, gb = out[..., :na], out[..., na:]
    if a.bias is not None:
        ga = ga + a.bias.to(ga.dtype)
    if b.bias is not None:
        gb = gb + b.bias.to(gb.dtype)
    return ga, gb


def quantize_dit_w8a8(model: nn.Module, min_dim: int = 1024,
                      align: int = 256) -> nn.Module:
    """Post-training w8a8 conversion in place, the counterpart of the JAX
    package's quantize_dit_params_w8a8: every nn.Linear or Q8Linear with
    min(K, N) >= min_dim and K, N multiples of `align` becomes a W8A8Linear;
    smaller and IO projections stay dense, and a Q8Linear that does not
    convert stays Q8. Layers are converted one at a time on their own
    device, so peak memory stays near the float model's. Swiglu gate/up
    pairs that both convert are laid out as one joint weight
    (fuse_gate_up). Returns the model."""
    targets = []
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, Q8Linear)):
            k, n = mod.in_features, mod.out_features
            if min(k, n) >= min_dim and k % align == 0 and n % align == 0:
                targets.append(name)
    for name in targets:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, attr, W8A8Linear.from_linear(getattr(parent, attr)))
    for mod in model.modules():
        gate = getattr(mod, "proj_in_gate", None)
        up = getattr(mod, "proj_in", None)
        if isinstance(gate, W8A8Linear) and isinstance(up, W8A8Linear):
            fuse_gate_up(gate, up)
    return model
