"""w8a8 serving lane: int8 x int8 -> int32 GEMM (kernel K3), the
quantization helpers, the w8a8 linears and the DiT conversion; and the
quantizing GEMM (kernel K10), an op with no caller on a serving path.

Port of seedvr2_tpu.ops.int8_matmul: weights are quantized per output
channel once, activations per row at run time, and

    out[m, n] = bf16((float(sum_k xq[m, k] * wq[n, k]) * xs[m]) * ws[n])

or the same product unrounded in fp32 (`out_dtype=torch.float32`), which a
row-sharded projection under tensor parallelism sums over the tp ranks
before its one rounding (`w8a8_linear(..., reduce)`).

Layout: the port stores a weight (N, K), K-contiguous (the JAX package
stores (K, N)), as 8-bit `wgmma` reads both operands; activations are
(M, K).

On a CUDA tensor `int8_matmul` and `int8_matmul_qx` launch their
hand-written kernels in `csrc/int8_matmul.cu`, one s8 GEMM body on the
tiles `plan_qx` picks (its comments say what bounds them and how they are
laid out); on a CPU tensor they run their plain versions.
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

    CPU tensors take the plain version. CUDA tensors launch the kernel (the
    s8 GEMM on the tiles `plan_qx` picks; out_dtype fp32 takes its fp32
    epilogue, the same accumulator stored unrounded), or raise on what it
    does not take: contiguous operands on one device, bf16 or fp32
    output, K % 32 == 0, K > 0, N % 8 == 0, 16-byte aligned xq and wq
    (what its TMA loads need; an operand that is not is refused, never
    copied)."""
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
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_matmul kernel writes bf16 or fp32, not "
                         f"{out_dtype}")
    for name, t, dt in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                        ("xs", xs, torch.float32), ("ws", ws, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != xq.device:
            raise ValueError(f"int8_matmul kernel: {name} must be contiguous "
                             f"{dt} on {xq.device}, got {t.dtype} on "
                             f"{t.device}")
    if k == 0 or k % 32 or n % 8 or xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"int8_matmul kernel: needs K % 32 == 0 (K={k}), "
                         f"N % 8 == 0 (N={n}) and 16-byte aligned operands")
    f32 = out_dtype == torch.float32
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m and n:
        swap, bt = plan_qx(m)
        err = _build.kernel_library().lib.seedvr2_int8_matmul(
            xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, n, k, int(f32), int(swap), bt,
            torch.cuda.current_stream(xq.device).cuda_stream)
        _build.check(err, "seedvr2_int8_matmul")
        int8_matmul.launches += 1
        int8_matmul.launches_f32 += f32
    return out


# launches of the kernel, and of them those with the fp32 epilogue
int8_matmul.launches = 0
int8_matmul.launches_f32 = 0


def quantize_rows_qx(x: torch.Tensor):
    """K10's per-row symmetric int8, as the TPU kernel _mm_qx_kernel
    computes it: scale = max(amax, 1e-8) * (1/127) and
    q = clip(round_half_even(x * (1 / scale)), -127, 127), the reciprocal
    multiplied where quantize_activations divides (the two can differ by a
    step). (..., K) -> ((..., K) int8, (...,) fp32)."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x32 * (1.0 / scale)), -127, 127)
    return q.to(torch.int8), scale.squeeze(-1)


def plan_qx(m: int):
    """The s8 GEMM's tiles for M token rows, for K3 and K10 alike: (swap,
    bt). At the video rows a block takes 128 tokens by bt = 256 weight
    rows; at M <= 64 the roles swap, 128 weight rows by bt = 8 or 64
    tokens (at least M), so N/128 blocks stream the weights where N/256
    would leave most SMs idle."""
    if m <= 8:
        return True, 8
    if m <= 64:
        return True, 64
    return False, 256


def int8_matmul_qx_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """Plain version of K10: quantize_rows_qx, then K3's plain product and
    epilogue; out_dtype defaults to x's."""
    q, s = quantize_rows_qx(x)
    return int8_matmul_plain(q, wq, s, ws,
                             x.dtype if out_dtype is None else out_dtype)


def int8_matmul_qx(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                   out_dtype=None) -> torch.Tensor:
    """x (M, K) bf16 or fp32 @ wq (N, K) int8 -> (M, N), with the per-row
    activation quantization (quantize_rows_qx), scaled by the row scales
    and ws (N,) fp32; out_dtype (bf16 or fp32) defaults to x's. An op only:
    the w8a8 lane runs the two-step form (a fused or plain quantize, then
    K3), as the JAX package does.

    CPU tensors take the plain version. CUDA tensors launch kernel K10 (its
    quantize pass into an (M, K) int8 scratch, then its s8 GEMM on the
    tiles `plan_qx` picks), or raise on what it does not take: contiguous
    operands on one device, K % 32 == 0, K > 0, N % 8 == 0, 16-byte
    aligned x and wq."""
    m, k = x.shape
    n, k2 = wq.shape
    if k != k2 or ws.shape != (n,):
        raise ValueError(f"int8_matmul_qx: shapes {tuple(x.shape)} "
                         f"{tuple(wq.shape)} {tuple(ws.shape)} do not match")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return int8_matmul_qx_plain(x, wq, ws, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_matmul_qx: no kernel for {x.device}")
    floats = (torch.bfloat16, torch.float32)
    if x.dtype not in floats or out_dtype not in floats:
        raise ValueError(f"int8_matmul_qx kernel takes and writes bf16 or "
                         f"fp32, not {x.dtype} -> {out_dtype}")
    for name, t, dt in (("x", x, x.dtype), ("wq", wq, torch.int8),
                        ("ws", ws, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"int8_matmul_qx kernel: {name} must be "
                             f"contiguous {dt} on {x.device}, got {t.dtype} "
                             f"on {t.device}")
    if k == 0 or k % 32 or n % 8 or x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"int8_matmul_qx kernel: needs K % 32 == 0 (K={k}),"
                         f" N % 8 == 0 (N={n}) and 16-byte aligned operands")
    # the quantize pass's row scales and int8 rows
    xs = torch.empty(m, dtype=torch.float32, device=x.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        swap, bt = plan_qx(m)
        err = _build.kernel_library().lib.seedvr2_int8_matmul_qx(
            x.data_ptr(), wq.data_ptr(), ws.data_ptr(), xs.data_ptr(),
            xq.data_ptr(), out.data_ptr(), m, n, k,
            int(x.dtype == torch.float32), int(out_dtype == torch.float32),
            int(swap), bt, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "seedvr2_int8_matmul_qx")
        int8_matmul_qx.launches += 1
    return out


int8_matmul_qx.launches = 0


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


def _product(x, wq: torch.Tensor, ws: torch.Tensor, use_kernels: bool,
             reduce=None):
    """x (float tensor or PreQuantized) @ wq^T with scales, as (lead, N) in
    x's dtype; float inputs are quantized per row first. reduce: the
    product is taken in fp32, summed in place by `reduce`, then rounded."""
    if isinstance(x, PreQuantized):
        q, s, dtype = x.q, x.s, x.dtype
    else:
        (q, s), dtype = quantize_activations(x), x.dtype
    lead, k = q.shape[:-1], q.shape[-1]
    matmul = int8_matmul if use_kernels else int8_matmul_plain
    out = matmul(q.reshape(-1, k), wq, s.reshape(-1), ws,
                 out_dtype=dtype if reduce is None else torch.float32)
    if reduce is not None:
        out = reduce(out).to(dtype)
    return out.reshape(*lead, wq.shape[0])


def w8a8_linear(x, layer: W8A8Linear, use_kernels: bool = True,
                reduce=None) -> torch.Tensor:
    """Drop-in linear: x quantized per row (or a PreQuantized from a fused
    producer), int8 GEMM, then the bias in the output dtype.

    reduce: row-sharded tensor parallelism, as the JAX package's
    psum_axis: a float x is quantized per row over its LOCAL K slice (a
    finer scale grid than one rank's full-K absmax), a PreQuantized x
    comes from K5 on the local hidden columns; K3 writes the fp32
    partial, `reduce` sums it over the tp ranks, one rounding to x's
    dtype, and the replicated bias once."""
    out = _product(x, layer.w8a8, layer.ws, use_kernels, reduce)
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
