"""Packed window attention (kernel K1).

Port of seedvr2_tpu.ops.attention.packed_attention and of the Pallas TPU
kernel it routes to, `flash_packed_attention` / `_fa_packed_kernel`. One
call attends every window row of a shape group at once, reading q, k and v
in place from ONE packed (B, S, 3*H*D) projection:

  per head: fp32 RMS qk-norm, interleaved rotate-half RoPE from (S, D) fp32
  tables that carry the qk-norm weights and the baked text rope, then
  softmax(q k^T * scale) v with key columns >= kv_len masked.

On a CUDA tensor `packed_window_attention` launches the hand-written Hopper
kernel `csrc/packed_attention.cu` (its header says what bounds it on an
H100 and how it is laid out); on a CPU tensor it runs the plain version.
"""

import torch

from . import _build
from .attention import attention_xla
from ..models.dit.rope import rotate_half_full

_LOG2E = 1.4426950408889634
_BLOCK_ROWS = 64  # the kernel's q and k tile height
_HEAD_DIMS = (64, 128)


def packed_window_attention_plain(qkv: torch.Tensor, heads: int, d: int,
                                  cos_q, sin_q, cos_k, sin_k, eps: float,
                                  kv_len: int) -> torch.Tensor:
    """Plain version: the JAX package's jnp composition
    (ops/attention.py packed_attention, non-kernel branch), softmax scale
    d**-0.5."""
    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, heads, d)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]

    def norm(z):
        z32 = z.float()
        return z32 * torch.rsqrt(torch.mean(z32 * z32, dim=-1, keepdim=True)
                                 + eps)

    def rope(z, cos, sin):
        c = cos.float()[:, None, :]
        sn = sin.float()[:, None, :]
        return z * c + rotate_half_full(z) * sn

    q = rope(norm(q), cos_q, sin_q).to(qkv.dtype)
    k = rope(norm(k), cos_k, sin_k).to(qkv.dtype)
    bias = None
    if kv_len < s:
        col = torch.arange(s, device=qkv.device)
        bias = torch.where(col < kv_len, 0.0, float("-inf")).float()
        bias = bias[None, None, :]
    out = attention_xla(q, k, v, scale=d ** -0.5, bias=bias)
    return out.reshape(b, s, heads * d)


def _check_table(t: torch.Tensor, s: int, d: int, device) -> None:
    if (t.dtype != torch.float32 or t.shape != (s, d)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"rope tables must be contiguous fp32 ({s}, {d}) on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")


def packed_window_attention(qkv: torch.Tensor, heads: int, d: int,
                            cos_q: torch.Tensor, sin_q: torch.Tensor,
                            cos_k: torch.Tensor, sin_k: torch.Tensor,
                            eps: float, kv_len: int) -> torch.Tensor:
    """qkv (B, S, 3*H*D), tables (S, D) fp32 -> (B, S, H*D).

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise on what it does not take: qkv must be contiguous bf16 with
    S % 64 == 0 and D in (64, 128); 1 <= kv_len <= S."""
    if qkv.device.type == "cpu":
        return packed_window_attention_plain(qkv, heads, d, cos_q, sin_q,
                                             cos_k, sin_k, eps, kv_len)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"packed attention: no kernel for {qkv.device}")
    b, s, width = qkv.shape
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("packed attention kernel takes contiguous bf16 qkv, "
                         f"got {qkv.dtype}")
    if width != 3 * heads * d or d not in _HEAD_DIMS:
        raise ValueError(f"packed attention kernel: width {width} != 3*{heads}"
                         f"*{d} or head dim not in {_HEAD_DIMS}")
    if s % _BLOCK_ROWS or not 1 <= kv_len <= s:
        raise ValueError(f"packed attention kernel: S={s} must be a multiple "
                         f"of {_BLOCK_ROWS} and 1 <= kv_len={kv_len} <= S")
    if b > 65535 or heads > 65535:
        raise ValueError("packed attention kernel: grid too large")
    for t in (cos_q, sin_q, cos_k, sin_k):
        _check_table(t, s, d, qkv.device)
    out = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.kernel_library().lib
    err = lib.seedvr2_packed_attention(
        qkv.data_ptr(), cos_q.data_ptr(), sin_q.data_ptr(), cos_k.data_ptr(),
        sin_k.data_ptr(), out.data_ptr(), b, s, heads, d, kv_len, float(eps),
        float(d ** -0.5 * _LOG2E),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(err, "seedvr2_packed_attention")
    packed_window_attention.launches += 1
    return out


packed_window_attention.launches = 0
