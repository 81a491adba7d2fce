"""Fused activation-quantize producers for the w8a8 serving lane (kernels K4
and K5).

Port of seedvr2_tpu.ops.fused_quant. The w8a8 linears (ops/int8_matmul.py)
take int8 activations with one fp32 scale per row. Two producers feed them
in every DiT block, and each is fused with the quantization into one pass:

 - K4 `rms_ada_quantize`: rms_norm(x) * scale + shift in fp32 (AdaSingle
   modulation, the scale/shift rows already summed with the per-channel
   tables), then the per-row int8 quantization; feeds qkv and gate+up.
 - K5 `silu_mul_quantize`: silu(g) * u in fp32, then the same quantization;
   feeds the swiglu mlp's proj_out.

The quantization (`_quant_rows`): sc = max(absmax(y), 1e-8) / 127,
q = clip(round_half_even(y / sc), -127, 127).

On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/fused_quant.cu`; the source says what bounds them and why they are
shaped so); on a CPU tensor it runs the plain version. The TPU entry points
route L % 32 != 0 or K % 256 != 0 to their jnp fallback, which computes the
same function; the port's kernels take every L (text rows, L = 58, go
through them too), so that routing is not copied.
"""

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build


class PreQuantized(NamedTuple):
    """Per-row int8 activations with their scales, accepted by
    ops.layers.linear and the w8a8 helpers in place of a float tensor.
    `dtype` is the float dtype the consuming matmul returns."""

    q: torch.Tensor       # (..., K) int8
    s: torch.Tensor       # (...,) fp32 per-row scales
    dtype: torch.dtype

    @property
    def shape(self):
        return self.q.shape


def _quant_rows(y32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of an fp32 tensor: (q, scales keepdim)."""
    amax = torch.amax(torch.abs(y32), dim=-1, keepdim=True)
    sc = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(y32 / sc), -127, 127).to(torch.int8)
    return q, sc


def rms_ada_quantize_plain(x: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor, eps: float) -> PreQuantized:
    """Plain version of K4: x (B, L, K), scale/shift (B, K)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)) * scale[:, None, :].float() \
        + shift[:, None, :].float()
    q, sc = _quant_rows(y)
    return PreQuantized(q, sc[..., 0], x.dtype)


def silu_mul_quantize_plain(g: torch.Tensor, u: torch.Tensor) -> PreQuantized:
    """Plain version of K5: g, u (B, L, K)."""
    y = F.silu(g.float()) * u.float()
    q, sc = _quant_rows(y)
    return PreQuantized(q, sc[..., 0], g.dtype)


# K4's persistent grid: a thread owns K4_CPT chunks of 8 columns, a block
# one row at a time and at most K4_MAX_THREADS threads
K4_CPT, K4_MAX_THREADS = 2, 512
K4_MAX_K = K4_CPT * 8 * K4_MAX_THREADS


class K4Plan(NamedTuple):
    threads: int   # a block, a multiple of 32
    grid: int      # persistent blocks, each walking rows grid apart


def plan_k4(rows: int, k: int, resident) -> K4Plan:
    """K4's launch for `rows` rows of K values: K / 16 threads a block
    rounded up to whole warps, and as many blocks as the card holds at once
    (`resident(threads)`), no more than there are rows. Raises on a K the
    kernel does not take (K % 8, K > K4_MAX_K)."""
    if k <= 0 or k % 8 or k > K4_MAX_K:
        raise ValueError(f"rms_ada_quantize kernel takes K a multiple of 8 "
                         f"up to {K4_MAX_K}, got {k}")
    threads = -(-k // (8 * K4_CPT * 32)) * 32
    return K4Plan(threads, max(1, min(rows, resident(threads))))


_RESIDENT = {}


def _resident(device: torch.device):
    """resident(threads) for `device`: the K4 blocks it holds at once."""
    def resident(threads: int) -> int:
        key = (device, threads)
        if key not in _RESIDENT:
            out = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = _build.kernel_library().lib.\
                    seedvr2_rms_ada_quantize_resident(threads,
                                                      ctypes.byref(out))
            _build.check(err, "seedvr2_rms_ada_quantize_resident")
            if out.value <= 0:
                raise RuntimeError(f"rms_ada_quantize: no block of {threads} "
                                   f"threads fits {device}")
            _RESIDENT[key] = out.value
        return _RESIDENT[key]
    return resident


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16 or t.dim() != 3 or t.stride(-1) != 1:
        raise ValueError(f"{name} kernel takes (B, L, K) bf16 rows with unit "
                         f"column stride, got {tuple(t.shape)} {t.dtype} "
                         f"strides {t.stride()}")
    b, l, k = t.shape
    if k % 8 or t.stride(1) % 8 or t.stride(0) != l * t.stride(1):
        raise ValueError(f"{name} kernel: K={k} and the row stride "
                         f"{t.stride(1)} must be multiples of 8, rows evenly "
                         "spaced across the batch")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} kernel: rows must start 16-byte aligned")


def _outputs(b: int, l: int, k: int, device):
    return (torch.empty((b, l, k), dtype=torch.int8, device=device),
            torch.empty((b, l), dtype=torch.float32, device=device))


def rms_ada_quantize(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     eps: float = 1e-5) -> PreQuantized:
    """quantize(rms_norm(x) * scale + shift) in one pass.

    x: (B, L, K); scale/shift: (B, K) fp32, the AdaSingle rows with the
    per-channel tables already added. Returns q (B, L, K) int8 and
    s (B, L) fp32. CPU tensors take the plain version; CUDA tensors launch
    K4, or raise on what it does not take (x contiguous bf16 with
    K % 8 == 0 and K <= K4_MAX_K, contiguous fp32 scale/shift on the same
    device)."""
    if x.device.type == "cpu":
        return rms_ada_quantize_plain(x, scale, shift, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rms_ada_quantize: no kernel for {x.device}")
    if not x.is_contiguous():
        raise ValueError("rms_ada_quantize kernel takes contiguous x")
    _check_rows("rms_ada_quantize", x)
    b, l, k = x.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.dtype != torch.float32 or t.shape != (b, k)
                or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"rms_ada_quantize kernel: {name} must be "
                             f"contiguous 16-byte aligned fp32 ({b}, {k}) on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    plan = plan_k4(b * l, k, _resident(x.device))
    q, s = _outputs(b, l, k, x.device)
    if q.numel():
        err = _build.kernel_library().lib.seedvr2_rms_ada_quantize(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), q.data_ptr(),
            s.data_ptr(), b * l, l, k, float(eps), plan.threads, plan.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "seedvr2_rms_ada_quantize")
        rms_ada_quantize.launches += 1
    return PreQuantized(q, s, x.dtype)


rms_ada_quantize.launches = 0


def silu_mul_quantize(g: torch.Tensor, u: torch.Tensor) -> PreQuantized:
    """quantize(silu(g) * u) in one read of each operand: the swiglu mlp's
    proj_out producer. g, u: (B, L, K), typically the two halves of one
    (B, L, 2K) gate+up product (strided views: read in place).

    CPU tensors take the plain version; CUDA tensors launch K5, or raise on
    what it does not take (bf16, unit column stride, K and the row stride
    multiples of 8, the same strides for g and u)."""
    if g.shape != u.shape:
        raise ValueError(f"silu_mul_quantize: shapes {tuple(g.shape)} and "
                         f"{tuple(u.shape)} differ")
    if g.device.type == "cpu":
        return silu_mul_quantize_plain(g, u)
    if g.device.type != "cuda":
        raise RuntimeError(f"silu_mul_quantize: no kernel for {g.device}")
    _check_rows("silu_mul_quantize", g)
    _check_rows("silu_mul_quantize", u)
    if g.stride() != u.stride() or g.device != u.device:
        raise ValueError("silu_mul_quantize kernel: g and u must share "
                         "strides and device")
    b, l, k = g.shape
    q, s = _outputs(b, l, k, g.device)
    if q.numel():
        err = _build.kernel_library().lib.seedvr2_silu_mul_quantize(
            g.data_ptr(), u.data_ptr(), q.data_ptr(), s.data_ptr(), b * l, k,
            g.stride(1), torch.cuda.current_stream(g.device).cuda_stream)
        _build.check(err, "seedvr2_silu_mul_quantize")
        silu_mul_quantize.launches += 1
    return PreQuantized(q, s, g.dtype)


silu_mul_quantize.launches = 0
