"""Flash attention kernels K1, K8 and K9.

Ports of the Pallas TPU kernels of seedvr2_tpu.ops.flash_attention, each
with its plain version:

 - K1 `packed_window_attention` (`flash_packed_attention` /
   `_fa_packed_kernel`, reached through ops.attention.packed_attention):
   the grouped window plan's attention. One call attends every window row
   of a shape group at once, reading q, k and v in place from ONE packed
   (B, S, 3*H*D) projection: per head fp32 RMS qk-norm, interleaved
   rotate-half RoPE from (S, D) fp32 tables that carry the qk-norm weights
   and the baked text rope, then softmax(q k^T * scale) v with key columns
   >= kv_len masked.
 - K9 `flash_windowed_attention` (`_fa_rope_mask_kernel`): the uniform
   window plan's attention over (B*nW, S, H, D) windows, each roped by the
   table its id picks and masked by that id's key validity row.
 - K8 `flash_attention` (`_fa_kernel` / `_fa_rope_kernel`): dense
   attention with an optional shared rope table and a kv_len mask, Sq != Sk
   allowed without rope; the dense branch of ops.attention.attention, which
   no product path takes (as in the JAX package).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(`csrc/packed_attention.cu`, `csrc/flash_attention.cu`; their headers say
what bounds them on an H100 and how they are laid out) or raises on what
it does not take; on a CPU tensor it runs the plain version. K1, K8 and K9
share one Hopper attention step, fed by a pre-pass that normalises (K1)
and ropes q and k once (`attention_prepass`, plainly `norm_rope_plain`;
K9's rows each by the table their id picks); one counted call launches
both. K9's step walks only the key tiles that hold a valid key
(`live_key_tiles`).

K1's gradient (`packed_window_attention_grad`, the `PackedWindowAttention`
autograd Function; the JAX package differentiates its jnp composition and
has no backward kernel): the forward launches K1's training launch
(`packed_window_attention_lse`: the serving kernel's instantiation that
also stores each row's log-sum-exp, exp2 domain; plainly
`packed_window_attention_lse_plain`) and saves qkv, the four tables, the
output and that lse; the backward (`packed_window_attention_backward`,
`csrc/attention_backward.cu`) relaunches K1's pre-pass for q-hat and
k-hat, then three parts, each with its plain version: the dq kernel (D =
rowsum(dO * O), then one sweep of the live key tiles for dQ-hat from the
forward's lse; `attention_backward_dq`), the dk/dv kernel (per 64-key tile
over the q tiles; `attention_backward_dkdv`), both on K1's Hopper step
(TMA rings, every product a `wgmma`, P and dS rounded to bf16 as
tensor-core operands, P as bf16 hi + lo for dV; tiles from
`backward_plan`), and the pre-pass backward (through the scale, the
rotation and the RMS norm to the q / k columns of d qkv, and the four fp32
table gradients summed over batch rows and heads from per-row partials
folded in a fixed order; `prepass_backward`). Output rows at or past
kv_len are the lane pad, which the caller discards: their cotangent is
taken as zero, so every row at or past kv_len gets zero gradient. No float
atomics and one block per output tile: reruns are bit-identical. The raw
wrappers refuse an input that needs a gradient while grad mode is on
(their outputs have no autograd history).

K9's gradient (`flash_windowed_attention_grad`, the `WindowedAttention`
autograd Function; the uniform window plan's training path; the JAX
package differentiates its jnp composition and has no backward kernel):
the forward launches K9's training launch (`flash_windowed_attention_lse`,
the step's MASKED LSE instantiation; plainly
`flash_windowed_attention_lse_plain`) and saves q, k, v, the output and
the lse; the backward (`flash_windowed_attention_backward`) relaunches
K9's pre-pass, then three parts, each with its plain version: K1's dq and
dk/dv kernels in their MASKED variant (`windowed_backward_dq`,
`windowed_backward_dkdv`: each window row's keys from the validity row its
id picks, dq walking only the live key tiles, a dk/dv block of no valid
key writing zeros; every q row counts, the rows the caller crops arriving
with dO = 0) and the rope backward by window id (`windowed_rope_backward`:
K9's pre-pass only ropes, with plan-constant tables, so no norm and no
table gradients). The same guarantees as K1's: no float atomics, reruns
bit-identical.
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .attention import attention_xla
from .gather import RowIndex
from ..models.dit.rope import apply_rope_ext, rotate_half_full

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_HEAD_DIMS = (64, 128)


def norm_rope_plain(x: torch.Tensor, cos: Optional[torch.Tensor],
                    sin: Optional[torch.Tensor], eps: Optional[float] = None,
                    mult: float = 1.0,
                    ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the K1/K8/K9 pre-pass: x (B, S, H, D) in fp32,
    RMS-normed over D when eps is given, rotated by interleaved rotate-half
    RoPE with (R, D) fp32 tables (R <= S: rows at or past R pass through
    unrotated; no rotation without tables), times mult, rounded back to x's
    dtype. With ids (B integer ids, K9) the tables are (nU, R, D) and batch
    row b takes table ids[b]. The plain attention functions take it with
    mult = 1 and scale their fp32 logits; the kernels fold mult =
    scale*log2e into q."""
    z = x.float()
    if eps is not None:
        z = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + eps)
    if cos is not None:
        if ids is not None:
            ids = ids.to(cos.device).long()
            cos, sin = cos[ids], sin[ids]
        s, rows = z.shape[-3], cos.shape[-2]
        if rows < s:
            cos = F.pad(cos, (0, 0, 0, s - rows), value=1.0)
            sin = F.pad(sin, (0, 0, 0, s - rows))
        z = (z * cos.float().unsqueeze(-2)
             + rotate_half_full(z) * sin.float().unsqueeze(-2))
    if mult != 1.0:
        z = z * mult
    return z.to(x.dtype)


def packed_window_attention_plain(qkv: torch.Tensor, heads: int, d: int,
                                  cos_q, sin_q, cos_k, sin_k, eps: float,
                                  kv_len: int) -> torch.Tensor:
    """Plain version: the JAX package's jnp composition
    (ops/attention.py packed_attention, non-kernel branch), softmax scale
    d**-0.5."""
    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, heads, d)
    q = norm_rope_plain(x[:, :, 0], cos_q, sin_q, eps)
    k = norm_rope_plain(x[:, :, 1], cos_k, sin_k, eps)
    v = x[:, :, 2]
    bias = None
    if kv_len < s:
        col = torch.arange(s, device=qkv.device)
        bias = torch.where(col < kv_len, 0.0, float("-inf")).float()
        bias = bias[None, None, :]
    out = attention_xla(q, k, v, scale=d ** -0.5, bias=bias)
    return out.reshape(b, s, heads * d)


def _check_table(t: torch.Tensor, shape, device) -> None:
    if (t.dtype != torch.float32 or t.shape != shape
            or not t.is_contiguous() or t.device != device
            or t.data_ptr() % 16):
        raise ValueError(f"rope tables must be contiguous, 16-byte aligned "
                         f"fp32 {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_ids(ids: RowIndex, b: int, n_u: int, device) -> None:
    """K9's window ids as its kernels take them: B int32 ids < nU on the
    operands' device."""
    t = ids.tensor
    if (len(ids) != b or ids.hi >= n_u or t.dtype != torch.int32
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"window ids must be {b} contiguous int32 ids < "
                         f"{n_u} on {device}, got {len(ids)} up to {ids.hi} "
                         f"({t.dtype} on {t.device})")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The tensor maps and the pre-pass's 16-byte loads need 16-byte aligned
    operands (every tensor the allocator hands out is)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} kernel takes 16-byte aligned operands")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_prepass(q: torch.Tensor, k: torch.Tensor,
                      cos_q: Optional[torch.Tensor],
                      sin_q: Optional[torch.Tensor],
                      cos_k: Optional[torch.Tensor],
                      sin_k: Optional[torch.Tensor],
                      eps: Optional[float] = None, mult: float = 1.0,
                      ids: Optional[RowIndex] = None):
    """The K1/K8/K9 pre-pass alone: (norm_rope_plain(q, cos_q, sin_q, eps,
    mult, ids), norm_rope_plain(k, cos_k, sin_k, eps, ids=ids)) as
    contiguous tensors. q (B, Sq, H, D), k (B, Sk, H, D); their rows may be
    strided (K1's q and k columns of the packed operand). Tables: (R, D)
    fp32 with one R <= S for both sides, or None for both; with ids (K9: B
    window ids, a RowIndex) (nU, R, D) tables of which row b takes ids[b]'s.

    CPU tensors take the plain version. CUDA tensors launch the pre-pass
    kernel, the one K1's, K8's and K9's wrappers launch before their
    attention step (so chip_smoke.py can time it alone), or raise on what
    it does not take: bf16 q, k with heads and D contiguous, D in (64,
    128)."""
    _build.refuse_grad("attention pre-pass", q, k, cos_q, sin_q, cos_k, sin_k)
    if ids is not None and cos_q is None:
        raise ValueError("attention pre-pass: window ids without tables")
    id_t = None if ids is None else ids.tensor
    if q.device.type == "cpu":
        return (norm_rope_plain(q, cos_q, sin_q, eps, mult, id_t),
                norm_rope_plain(k, cos_k, sin_k, eps, ids=id_t))
    if q.device.type != "cuda":
        raise RuntimeError(f"attention pre-pass: no kernel for {q.device}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    for t in (q, k):
        if (t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[0] != b
                or t.shape[2:] != (h, d) or t.stride(3) != 1
                or t.stride(2) != d or t.stride(0) != t.shape[1] * t.stride(1)
                or t.stride(1) % 8 or t.device != q.device):
            raise ValueError("attention pre-pass kernel takes bf16 (B, S, H, "
                             "D) q and k with heads and D contiguous")
    if d not in _HEAD_DIMS or (cos_q is None) != (cos_k is None):
        raise ValueError(f"attention pre-pass kernel: head dim {d} not in "
                         f"{_HEAD_DIMS}, or tables for one side only")
    rows = 0
    if cos_q is not None:
        rows = cos_q.shape[-2]
        if rows > min(sq, sk):
            raise ValueError(f"attention pre-pass: {rows} table rows > S")
        shape = (rows, d)
        if ids is not None:
            shape = (cos_q.shape[0], rows, d)
            _check_ids(ids, b, shape[0], q.device)
        for t in (cos_q, sin_q, cos_k, sin_k):
            _check_table(t, shape, q.device)
    _check_aligned("attention pre-pass", q, k)
    q_hat = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    k_hat = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.kernel_library().lib.seedvr2_qk_prepass(
        q.data_ptr(), q.stride(1), k.data_ptr(), k.stride(1), ptr(cos_q),
        ptr(sin_q), ptr(cos_k), ptr(sin_k), ptr(id_t), q_hat.data_ptr(),
        k_hat.data_ptr(), b, sq, sk, h, d, rows, int(eps is not None),
        float(eps or 0.0), float(mult), _stream(q))
    _build.check(err, "seedvr2_qk_prepass")
    return q_hat, k_hat


def packed_window_attention(qkv: torch.Tensor, heads: int, d: int,
                            cos_q: torch.Tensor, sin_q: torch.Tensor,
                            cos_k: torch.Tensor, sin_k: torch.Tensor,
                            eps: float, kv_len: int) -> torch.Tensor:
    """qkv (B, S, 3*H*D), tables (S, D) fp32 -> (B, S, H*D).

    CPU tensors take the plain version. CUDA tensors launch the kernel (its
    pre-pass, then its attention step), or raise on what it does not take:
    qkv must be contiguous bf16 with D in (64, 128); 1 <= kv_len <= S.
    Inputs that need a gradient while grad mode is on are refused on every
    device: `packed_window_attention_grad` carries one."""
    _build.refuse_grad("packed window attention", qkv, cos_q, sin_q, cos_k,
                       sin_k)
    if qkv.device.type == "cpu":
        return packed_window_attention_plain(qkv, heads, d, cos_q, sin_q,
                                             cos_k, sin_k, eps, kv_len)
    _check_k1(qkv, heads, d, (cos_q, sin_q, cos_k, sin_k), kv_len)
    b, s, _ = qkv.shape
    # q-hat and k-hat: normed, roped (q times scale*log2e) bf16
    scratch = torch.empty((2, b, s, heads, d), dtype=qkv.dtype,
                          device=qkv.device)
    out = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    lib = _build.kernel_library().lib
    err = lib.seedvr2_packed_attention(
        qkv.data_ptr(), cos_q.data_ptr(), sin_q.data_ptr(), cos_k.data_ptr(),
        sin_k.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, s, heads, d,
        kv_len, float(eps), float(d ** -0.5 * _LOG2E), _stream(qkv))
    _build.check(err, "seedvr2_packed_attention")
    packed_window_attention.launches += 1
    return out


packed_window_attention.launches = 0
packed_window_attention.launches_lse = 0


def _check_k1(qkv: torch.Tensor, heads: int, d: int, tables,
              kv_len: int) -> None:
    """What K1's kernel takes: contiguous bf16 (B, S, 3*H*D) qkv on a CUDA
    device, D in (64, 128), 1 <= kv_len <= S, (S, D) fp32 tables."""
    if qkv.device.type != "cuda":
        raise RuntimeError(f"packed attention: no kernel for {qkv.device}")
    b, s, width = qkv.shape
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("packed attention kernel takes contiguous bf16 qkv, "
                         f"got {qkv.dtype}")
    if width != 3 * heads * d or d not in _HEAD_DIMS:
        raise ValueError(f"packed attention kernel: width {width} != 3*{heads}"
                         f"*{d} or head dim not in {_HEAD_DIMS}")
    if not 1 <= kv_len <= s:
        raise ValueError(f"packed attention kernel: 1 <= kv_len={kv_len} <= "
                         f"S={s} does not hold")
    if b > 65535 or heads > 65535:
        raise ValueError("packed attention kernel: grid too large")
    for t in tables:
        _check_table(t, (s, d), qkv.device)
    _check_aligned("packed attention", qkv)


def _first_keys(kv_len: int, s: int, device) -> torch.Tensor:
    """(1, S) bool: the keys below kv_len (K1's)."""
    return (torch.arange(s, device=device) < kv_len)[None]


def _window_keys(kv_valid: torch.Tensor, table_ids: RowIndex,
                 device) -> torch.Tensor:
    """(B, S) bool: each window row's keys, the validity row its id picks
    (K9's)."""
    return kv_valid.to(device)[table_ids.tensor.to(device).long()].bool()


def _lse_plain(q_hat: torch.Tensor, k_hat: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """Each row's log-sum-exp of its scores q_hat . k_hat over the keys
    `keep` (B or 1, S) marks, in the log2 domain (q_hat carries
    scale*log2e): (B, S, H, D) q_hat and k_hat -> (B, H, S) fp32."""
    sc = torch.einsum("bqhd,bkhd->bhqk", q_hat.float(), k_hat.float())
    sc = sc.masked_fill(~keep[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(sc - m).sum(dim=-1, keepdim=True))
    return lse[..., 0].contiguous()


def attention_lse_plain(q_hat: torch.Tensor, k_hat: torch.Tensor,
                        kv_len: int) -> torch.Tensor:
    """Each row's log-sum-exp of its scores q_hat . k_hat over the keys
    below kv_len, in the log2 domain (q_hat carries scale*log2e): (B, S, H,
    D) q_hat and k_hat -> (B, H, S) fp32."""
    return _lse_plain(q_hat, k_hat,
                      _first_keys(kv_len, q_hat.shape[1], q_hat.device))


def packed_window_attention_lse_plain(qkv: torch.Tensor, heads: int, d: int,
                                      cos_q, sin_q, cos_k, sin_k, eps: float,
                                      kv_len: int):
    """Plain version of K1's training launch: (packed_window_attention_plain
    (...), lse), lse (B, H, S) fp32 the attention_lse_plain of the plain
    composition's normed, roped q (times scale*log2e) and k, each rounded
    to qkv's dtype as K1's pre-pass rounds q-hat and k-hat."""
    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, heads, d)
    q_hat = norm_rope_plain(x[:, :, 0], cos_q, sin_q, eps, d ** -0.5 * _LOG2E)
    k_hat = norm_rope_plain(x[:, :, 1], cos_k, sin_k, eps)
    out = packed_window_attention_plain(qkv, heads, d, cos_q, sin_q, cos_k,
                                        sin_k, eps, kv_len)
    return out, attention_lse_plain(q_hat, k_hat, kv_len)


def packed_window_attention_lse(qkv: torch.Tensor, heads: int, d: int,
                                cos_q: torch.Tensor, sin_q: torch.Tensor,
                                cos_k: torch.Tensor, sin_k: torch.Tensor,
                                eps: float, kv_len: int):
    """K1's training launch: (out, lse) with out as packed_window_attention
    and lse (B, H, S) fp32 each row's log-sum-exp of its scores over the
    keys below kv_len (log2 domain), every row written: what the dq and
    dk/dv kernels of K1's backward read in place of a second sweep.

    CPU tensors take the plain version. CUDA tensors launch K1 (its
    pre-pass, then the step's LSE instantiation, which also stores m +
    log2(l) per row; the serving launches keep the other one), counted in
    packed_window_attention.launches and .launches_lse, or raise on what K1
    does not take. Refuses inputs that need a gradient, as K1 does."""
    _build.refuse_grad("packed window attention", qkv, cos_q, sin_q, cos_k,
                       sin_k)
    if qkv.device.type == "cpu":
        return packed_window_attention_lse_plain(qkv, heads, d, cos_q, sin_q,
                                                 cos_k, sin_k, eps, kv_len)
    _check_k1(qkv, heads, d, (cos_q, sin_q, cos_k, sin_k), kv_len)
    b, s, _ = qkv.shape
    scratch = torch.empty((2, b, s, heads, d), dtype=qkv.dtype,
                          device=qkv.device)
    out = torch.empty((b, s, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, s), dtype=torch.float32, device=qkv.device)
    err = _build.kernel_library().lib.seedvr2_packed_attention_lse(
        qkv.data_ptr(), cos_q.data_ptr(), sin_q.data_ptr(), cos_k.data_ptr(),
        sin_k.data_ptr(), scratch.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, s, heads, d, kv_len, float(eps), float(d ** -0.5 * _LOG2E),
        _stream(qkv))
    _build.check(err, "seedvr2_packed_attention_lse")
    packed_window_attention.launches += 1
    packed_window_attention.launches_lse += 1
    return out, lse


# ------------------------------------------------------------ K1 backward


def _masked_dout(dout: torch.Tensor, b: int, s: int, h: int, d: int,
                 kv_len: int) -> torch.Tensor:
    """dO as fp32 (B, S, H, D) with the rows at or past kv_len zeroed."""
    do = dout.float().reshape(b, s, h, d).clone()
    do[:, kv_len:] = 0.0
    return do


def _dq_plain(q_hat, k_hat, v, out, do, lse, keep):
    """dq_acc = sum_j dS_ij k_hat_j (fp32 (B, S, H, D)) and delta =
    rowsum(dO * O) ((B, H, S) fp32) from fp32 dO (B, S, H, D), P_ij =
    exp2(q_hat_i . k_hat_j - lse_i) over the keys `keep` (B or 1, S)
    marks, dS = P * (dO v^T - delta)."""
    b, s, h, d = q_hat.shape
    q, k, vv = q_hat.float(), k_hat.float(), v.float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(sc - lse.float()[..., None])
    p = p.masked_fill(~keep[:, None, None, :], 0.0)
    delta = (do * out.float().reshape(b, s, h, d)).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vv)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    return dq, delta.contiguous()


def _dkdv_plain(q_hat, k_hat, v, do, lse, delta, keep):
    """dk_acc = sum_i dS_ij q_hat_i (fp32 (B, S, H, D)) and dv = sum_i P_ij
    dO_i (v's dtype), as _dq_plain's P and dS; keys `keep` leaves out get
    zero."""
    q, k, vv = q_hat.float(), k_hat.float(), v.float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp2(sc - lse.float()[..., None])
    p = p.masked_fill(~keep[:, None, None, :], 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vv)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dk, dv.to(v.dtype)


def attention_backward_dq_plain(q_hat: torch.Tensor, k_hat: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                dout: torch.Tensor, lse: torch.Tensor,
                                kv_len: int):
    """Plain version of the dq kernel. q_hat, k_hat (B, S, H, D): K1's
    pre-pass output (q times scale*log2e, so the scores are in the exp2
    domain); v (B, S, H, D); out, dout (B, S, H*D); lse (B, H, S) fp32, the
    rows' log-sum-exp in the log2 domain from K1's forward
    (packed_window_attention_lse). Returns (dq_acc = sum_j dS_ij k_hat_j as
    fp32 (B, S, H, D), delta = rowsum(dO * O) (B, H, S) fp32), with P_ij =
    exp2(q_hat_i . k_hat_j - lse_i) over the keys below kv_len and dS =
    P * (dO v^T - delta); dO rows at or past kv_len count as zero."""
    b, s, h, d = q_hat.shape
    return _dq_plain(q_hat, k_hat, v, out,
                     _masked_dout(dout, b, s, h, d, kv_len), lse,
                     _first_keys(kv_len, s, q_hat.device))


def attention_backward_dkdv_plain(q_hat: torch.Tensor, k_hat: torch.Tensor,
                                  v: torch.Tensor, dout: torch.Tensor,
                                  lse: torch.Tensor, delta: torch.Tensor,
                                  kv_len: int):
    """Plain version of the dk/dv kernel, from the forward's lse and the dq
    part's delta:
    (dk_acc = sum_i dS_ij q_hat_i as fp32 (B, S, H, D), dv = sum_i P_ij dO_i
    (B, S, H, D) in v's dtype); keys at or past kv_len get zero."""
    b, s, h, d = q_hat.shape
    return _dkdv_plain(q_hat, k_hat, v,
                       _masked_dout(dout, b, s, h, d, kv_len), lse, delta,
                       _first_keys(kv_len, s, q_hat.device))


def prepass_backward_plain(q: torch.Tensor, k: torch.Tensor,
                           cos_q: torch.Tensor, sin_q: torch.Tensor,
                           cos_k: torch.Tensor, sin_k: torch.Tensor,
                           eps: float, dq_acc: torch.Tensor,
                           dk_acc: torch.Tensor, gq: float, gk: float):
    """Plain version of the pre-pass backward. q, k (B, S, H, D): the raw
    q / k columns of qkv; tables (S, D) fp32; dq_acc, dk_acc (B, S, H, D)
    fp32 from the dq and dk/dv parts, times gq / gk (ln2 times the side's
    pre-pass multiplier: the scale for q, ln2 for k) the gradient of the
    roped rows. Back through the rotation (rot^T = -rot) and the RMS norm:
    (dq, dk in q's dtype, (d cos_q, d sin_q, d cos_k, d sin_k) fp32 (S, D)
    summed over batch rows and heads)."""
    outs, tabs = [], []
    for x, cos, sin, acc, g in ((q, cos_q, sin_q, dq_acc, gq),
                                (k, cos_k, sin_k, dk_acc, gk)):
        z = x.float()
        r = torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + eps)
        n = z * r
        gr = acc.float() * g
        c, sn = cos.float()[:, None, :], sin.float()[:, None, :]
        dn = gr * c - rotate_half_full(gr * sn)
        tabs += [(gr * n).sum(dim=(0, 2)),
                 (gr * rotate_half_full(n)).sum(dim=(0, 2))]
        dz = r * (dn - n * torch.mean(dn * n, dim=-1, keepdim=True))
        outs.append(dz.to(x.dtype))
    return outs[0], outs[1], tuple(tabs)


def packed_window_attention_backward_plain(qkv: torch.Tensor, heads: int,
                                           d: int, cos_q, sin_q, cos_k,
                                           sin_k, eps: float, kv_len: int,
                                           out: torch.Tensor,
                                           dout: torch.Tensor):
    """Plain version of K1's backward, the kernels' parts in their order
    (q-hat and k-hat kept in fp32, so the rows' lse is that of their fp32
    scores, formed here): (d qkv (B, S, 3*H*D) in qkv's dtype, d cos_q,
    d sin_q, d cos_k, d sin_k (S, D) fp32). dO rows at or past kv_len count
    as zero; every row at or past kv_len gets zero gradient."""
    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, heads, d)
    mult = d ** -0.5 * _LOG2E
    q_hat = norm_rope_plain(x[:, :, 0].float(), cos_q, sin_q, eps, mult)
    k_hat = norm_rope_plain(x[:, :, 1].float(), cos_k, sin_k, eps)
    v = x[:, :, 2]
    lse = attention_lse_plain(q_hat, k_hat, kv_len)
    dq, delta = attention_backward_dq_plain(q_hat, k_hat, v, out, dout, lse,
                                            kv_len)
    dk, dv = attention_backward_dkdv_plain(q_hat, k_hat, v, dout, lse, delta,
                                           kv_len)
    dqr, dkr, tabs = prepass_backward_plain(x[:, :, 0], x[:, :, 1], cos_q,
                                            sin_q, cos_k, sin_k, eps, dq, dk,
                                            d ** -0.5, _LN2)
    dqkv = torch.stack([dqr, dkr, dv], dim=2).reshape(b, s, 3 * heads * d)
    return (dqkv.to(qkv.dtype), *tabs)


def _check_rows(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: takes a contiguous, 16-byte aligned "
                         f"{dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_packed_v(name: str, v: torch.Tensor, b: int, s: int, h: int,
                    d: int) -> None:
    """v: the v columns of a contiguous packed (B, S, 3*H*D) bf16 qkv (or a
    contiguous (B, S, H, D))."""
    if (v.dtype != torch.bfloat16 or v.shape != (b, s, h, d)
            or v.stride(3) != 1 or v.stride(2) != d
            or v.stride(0) != s * v.stride(1) or v.stride(1) % 8
            or v.data_ptr() % 16):
        raise ValueError(f"{name}: v must be bf16 (B, S, H, D) rows with "
                         "heads and D contiguous, 16-byte aligned")


H100_SMS = 132  # the plan's SM count when no card is asked


class BackwardPlan(NamedTuple):
    """The tiles of K1's dq and dk/dv kernels for one (B, S, H, kv_len)."""

    wg: int         # dq: consumer warpgroups of 64 q rows a block
    blocks: int     # dq: blocks of wg * 64 q rows along S
    kv_blocks: int  # dk/dv: blocks of 64 keys along S (D / 64 warpgroups
                    # each, splitting a q tile's scores and D's columns)


def backward_plan(b: int, s: int, h: int, kv_len: int,
                  sms: int = H100_SMS) -> BackwardPlan:
    """The dq and dk/dv kernels' tile plan for B batch rows of S rows, H
    heads. Each kernel's blocks cover the S rows of every (b, h) once
    (blocks past kv_len write zeros). A dq block of two warpgroups shares
    its k-hat / v tiles between them and runs alone on an SM; one of one
    warpgroup runs two an SM with half the rows each, which spreads a group
    with fewer live 128-row blocks than the card has SMs (the training
    plan's B = 2, S = 128 groups: 40 blocks of 128 rows) over twice as many
    SMs. A dk/dv block owns 64 keys; its warpgroups split each q tile's
    scores and the 64-column panels of D."""
    live = b * h * -(-kv_len // 128)
    wg = 2 if live >= sms else 1
    return BackwardPlan(wg, -(-s // (64 * wg)), -(-s // 64))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_bwd(name: str, q_hat: torch.Tensor, k_hat: torch.Tensor,
               kv_len: int):
    if q_hat.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {q_hat.device}")
    b, s, h, d = q_hat.shape
    for t in (q_hat, k_hat):
        _check_rows(name, t, (b, s, h, d), torch.bfloat16, q_hat.device)
    if d not in _HEAD_DIMS or not 1 <= kv_len <= s or b > 65535 or h > 65535:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}, kv_len "
                         f"{kv_len} not in [1, {s}], or grid too large")
    return b, s, h, d


def attention_backward_dq(q_hat: torch.Tensor, k_hat: torch.Tensor,
                          v: torch.Tensor, out: torch.Tensor,
                          dout: torch.Tensor, lse: torch.Tensor,
                          kv_len: int):
    """The dq kernel of K1's backward (plain version on the CPU): (dq_acc,
    delta) as attention_backward_dq_plain, from the forward's lse. On a
    card: bf16 q_hat and k_hat (B, S, H, D) contiguous, v the packed
    operand's v columns, out and dout contiguous bf16 (B, S, H*D), lse
    contiguous fp32 (B, H, S); the tiles as backward_plan says."""
    if q_hat.device.type == "cpu":
        return attention_backward_dq_plain(q_hat, k_hat, v, out, dout, lse,
                                           kv_len)
    b, s, h, d = _check_bwd("attention backward dq", q_hat, k_hat, kv_len)
    _check_packed_v("attention backward dq", v, b, s, h, d)
    for t in (out, dout):
        _check_rows("attention backward dq", t, (b, s, h * d),
                    torch.bfloat16, q_hat.device)
    _check_rows("attention backward dq", lse, (b, h, s), torch.float32,
                q_hat.device)
    plan = backward_plan(b, s, h, kv_len, _sm_count(q_hat.device))
    dq = torch.empty((b, s, h, d), dtype=torch.float32, device=q_hat.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q_hat.device)
    err = _build.kernel_library().lib.seedvr2_attn_bwd_dq(
        q_hat.data_ptr(), k_hat.data_ptr(), v.data_ptr(), v.stride(1),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        delta.data_ptr(), b, s, h, d, kv_len, plan.wg, plan.blocks,
        _stream(q_hat))
    _build.check(err, "seedvr2_attn_bwd_dq")
    attention_backward_dq.launches += 1
    return dq, delta


attention_backward_dq.launches = 0


def attention_backward_dkdv(q_hat: torch.Tensor, k_hat: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            kv_len: int,
                            dv_out: Optional[torch.Tensor] = None):
    """The dk/dv kernel of K1's backward (plain version on the CPU):
    (dk_acc fp32 (B, S, H, D), dv bf16), from the forward's lse and the dq
    part's delta. On a card dv is written into `dv_out` when given (the v
    columns of a packed (B, S, 3*H*D) gradient, the view returned), else
    into a new (B, S, H, D); the tiles as backward_plan says."""
    if q_hat.device.type == "cpu":
        return attention_backward_dkdv_plain(q_hat, k_hat, v, dout, lse,
                                             delta, kv_len)
    b, s, h, d = _check_bwd("attention backward dk/dv", q_hat, k_hat, kv_len)
    _check_packed_v("attention backward dk/dv", v, b, s, h, d)
    _check_rows("attention backward dk/dv", dout, (b, s, h * d),
                torch.bfloat16, q_hat.device)
    for t in (lse, delta):
        _check_rows("attention backward dk/dv", t, (b, h, s), torch.float32,
                    q_hat.device)
    if dv_out is None:
        dv_out = torch.empty((b, s, h, d), dtype=torch.bfloat16,
                             device=q_hat.device)
    _check_packed_v("attention backward dk/dv (dv)", dv_out, b, s, h, d)
    plan = backward_plan(b, s, h, kv_len, _sm_count(q_hat.device))
    dk = torch.empty((b, s, h, d), dtype=torch.float32, device=q_hat.device)
    err = _build.kernel_library().lib.seedvr2_attn_bwd_dkdv(
        q_hat.data_ptr(), k_hat.data_ptr(), v.data_ptr(), v.stride(1),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv_out.data_ptr(), dv_out.stride(1), b, s, h, d, kv_len,
        plan.kv_blocks, _stream(q_hat))
    _build.check(err, "seedvr2_attn_bwd_dkdv")
    attention_backward_dkdv.launches += 1
    return dk, dv_out


attention_backward_dkdv.launches = 0


def prepass_backward(q: torch.Tensor, k: torch.Tensor, cos_q: torch.Tensor,
                     sin_q: torch.Tensor, cos_k: torch.Tensor,
                     sin_k: torch.Tensor, eps: float, dq_acc: torch.Tensor,
                     dk_acc: torch.Tensor, gq: float, gk: float,
                     out: Optional[torch.Tensor] = None):
    """The pre-pass backward kernel of K1's backward (plain version on the
    CPU): (dq, dk, (d cos_q, d sin_q, d cos_k, d sin_k)) as
    prepass_backward_plain. On a card q and k are the q / k columns of a
    contiguous packed bf16 qkv, and dq / dk are written into the q / k
    columns of `out` (a packed (B, S, 3*H*D) bf16 gradient) when given,
    else into new (B, S, H, D) tensors; the table gradients are per-row
    partials over the heads folded over the batch rows in order by a
    second launch."""
    if q.device.type == "cpu":
        return prepass_backward_plain(q, k, cos_q, sin_q, cos_k, sin_k, eps,
                                      dq_acc, dk_acc, gq, gk)
    if q.device.type != "cuda":
        raise RuntimeError(f"pre-pass backward: no kernel for {q.device}")
    b, s, h, d = q.shape
    name = "pre-pass backward"
    for t in (q, k):
        _check_packed_v(name, t, b, s, h, d)
    if q.stride(1) != k.stride(1):
        raise ValueError(f"{name}: q and k rows at different strides")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    for t in (cos_q, sin_q, cos_k, sin_k):
        _check_table(t, (s, d), q.device)
    for t in (dq_acc, dk_acc):
        _check_rows(name, t, (b, s, h, d), torch.float32, q.device)
    if out is None:
        dst = torch.empty((2, b, s, h, d), dtype=torch.bfloat16,
                          device=q.device)
        dq, dk = dst[0], dst[1]
        dq_ptr, dk_ptr, dst_stride = dq.data_ptr(), dk.data_ptr(), h * d
    else:
        _check_rows(name, out, (b, s, 3 * h * d), torch.bfloat16, q.device)
        x = out.view(b, s, 3, h, d)
        dq, dk = x[:, :, 0], x[:, :, 1]
        dq_ptr, dk_ptr, dst_stride = dq.data_ptr(), dk.data_ptr(), 3 * h * d
    partials = torch.empty((b, 4, s, d), dtype=torch.float32,
                           device=q.device)
    tables = torch.empty((4, s, d), dtype=torch.float32, device=q.device)
    err = _build.kernel_library().lib.seedvr2_prepass_bwd(
        q.data_ptr(), k.data_ptr(), q.stride(1), cos_q.data_ptr(),
        sin_q.data_ptr(), cos_k.data_ptr(), sin_k.data_ptr(),
        dq_acc.data_ptr(), dk_acc.data_ptr(), dq_ptr, dk_ptr, dst_stride,
        partials.data_ptr(), tables.data_ptr(), b, s, h, d, float(eps),
        float(gq), float(gk), _stream(q))
    _build.check(err, "seedvr2_prepass_bwd")
    prepass_backward.launches += 1
    return dq, dk, tuple(tables.unbind(0))


prepass_backward.launches = 0


def packed_window_attention_backward(qkv: torch.Tensor, heads: int, d: int,
                                     cos_q, sin_q, cos_k, sin_k, eps: float,
                                     kv_len: int, out: torch.Tensor,
                                     dout: torch.Tensor, lse: torch.Tensor):
    """K1's backward from the forward's output and lse
    (packed_window_attention_lse): (d qkv (B, S, 3*H*D), d cos_q, d sin_q,
    d cos_k, d sin_k (S, D) fp32). CPU tensors take the plain version,
    which keeps q-hat in fp32 and forms the lse of its own scores. CUDA
    tensors relaunch K1's pre-pass (q-hat, k-hat), then the dq, dk/dv and
    pre-pass backward kernels, which read lse (the kernels' bf16 q-hat is
    the forward's) and write d qkv's v, then q and k columns in place; what
    K1 does not take is refused as K1 refuses it."""
    if qkv.device.type == "cpu":
        return packed_window_attention_backward_plain(
            qkv, heads, d, cos_q, sin_q, cos_k, sin_k, eps, kv_len, out, dout)
    b, s, _ = qkv.shape
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous():
        raise ValueError("packed attention backward takes contiguous bf16 "
                         f"qkv, got {qkv.dtype}")
    x = qkv.view(b, s, 3, heads, d)
    q_hat, k_hat = attention_prepass(x[:, :, 0], x[:, :, 1], cos_q, sin_q,
                                     cos_k, sin_k, eps, d ** -0.5 * _LOG2E)
    dq, delta = attention_backward_dq(q_hat, k_hat, x[:, :, 2], out, dout,
                                      lse, kv_len)
    dqkv = torch.empty_like(qkv)
    dk, _ = attention_backward_dkdv(q_hat, k_hat, x[:, :, 2], dout, lse, delta,
                                    kv_len,
                                    dqkv.view(b, s, 3, heads, d)[:, :, 2])
    del q_hat, k_hat, delta
    _, _, tables = prepass_backward(x[:, :, 0], x[:, :, 1], cos_q, sin_q,
                                    cos_k, sin_k, eps, dq, dk, d ** -0.5,
                                    _LN2, out=dqkv)
    return (dqkv, *tables)


class PackedWindowAttention(torch.autograd.Function):
    """K1 with its gradient: the forward launches K1's training launch
    (packed_window_attention_lse; its plain version on the CPU) and saves
    qkv, the tables, the output and the rows' lse; the backward is
    packed_window_attention_backward, returning d qkv and the four table
    gradients."""

    @staticmethod
    def forward(ctx, qkv, cos_q, sin_q, cos_k, sin_k, heads, d, eps, kv_len):
        out, lse = packed_window_attention_lse(qkv, heads, d, cos_q, sin_q,
                                               cos_k, sin_k, eps, kv_len)
        ctx.save_for_backward(qkv, cos_q, sin_q, cos_k, sin_k, out, lse)
        ctx.args = (heads, d, eps, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, cos_q, sin_q, cos_k, sin_k, out, lse = ctx.saved_tensors
        heads, d, eps, kv_len = ctx.args
        grads = packed_window_attention_backward(
            qkv, heads, d, cos_q, sin_q, cos_k, sin_k, eps, kv_len, out,
            dout.contiguous(), lse)
        return (*grads, None, None, None, None)


def packed_window_attention_grad(qkv: torch.Tensor, heads: int, d: int,
                                 cos_q: torch.Tensor, sin_q: torch.Tensor,
                                 cos_k: torch.Tensor, sin_k: torch.Tensor,
                                 eps: float, kv_len: int) -> torch.Tensor:
    """packed_window_attention with a gradient: the kernel alone when no
    input needs one (or grad mode is off), else through
    PackedWindowAttention."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, cos_q, sin_q, cos_k, sin_k)):
        return PackedWindowAttention.apply(qkv, cos_q, sin_q, cos_k, sin_k,
                                           heads, d, eps, kv_len)
    return packed_window_attention(qkv, heads, d, cos_q, sin_q, cos_k, sin_k,
                                   eps, kv_len)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          rope_cos: Optional[torch.Tensor] = None,
                          rope_sin: Optional[torch.Tensor] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of K8: the JAX package's composition (ops/attention.py
    `attention`, non-kernel branch without table_ids). Tables with fewer
    rows than S get identity rows; q and k are roped in fp32 and rounded
    back to their dtype; key columns >= kv_len get a -inf logit bias."""
    sk = k.shape[-3]
    bias = None
    if kv_len is not None and kv_len < sk:
        col = torch.arange(sk, device=q.device)
        bias = torch.where(col < kv_len, 0.0, float("-inf"))[None, None, :]
    if rope_cos is not None:
        q = norm_rope_plain(q, rope_cos, rope_sin)
        k = norm_rope_plain(k, rope_cos, rope_sin)
    return attention_xla(q, k, v, scale=scale, bias=bias)


def flash_windowed_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, scale: Optional[float],
                                   rope_cos: torch.Tensor,
                                   rope_sin: torch.Tensor,
                                   table_ids: RowIndex,
                                   kv_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: the JAX package's composition (ops/attention.py
    `attention`, non-kernel branch with table_ids): every row's tables and
    key validity gathered by its id, q and k roped in fp32 and rounded back
    to their dtype, invalid keys given a -inf logit bias."""
    ids = table_ids.tensor.to(q.device).long()
    q = apply_rope_ext(q, rope_cos[ids], rope_sin[ids])
    k = apply_rope_ext(k, rope_cos[ids], rope_sin[ids])
    bias = torch.where(kv_valid[ids], 0.0, float("-inf"))[:, None, None, :]
    return attention_xla(q, k, v, scale=scale, bias=bias)


def _check_cuda_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """What the K8/K9 kernel takes: contiguous bf16 q, k, v on one CUDA
    device, head dim in _HEAD_DIMS, batch rows and heads within the grid."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {q.device}")
    for t in (q, k, v):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} kernel takes contiguous bf16 q, k, v on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    b, _, h, d = q.shape
    if d not in _HEAD_DIMS or b > 65535 or h > 65535:
        raise ValueError(f"{name} kernel: head dim {d} not in {_HEAD_DIMS}, "
                         f"or {b} rows / {h} heads beyond the grid")
    _check_aligned(name, q, k, v)


def _qscale(scale: Optional[float], d: int) -> float:
    return float(((d ** -0.5) if scale is None else scale) * _LOG2E)


def _check_windowed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                    table_ids: RowIndex, kv_valid: torch.Tensor):
    """K9's shapes, on every device: q, k, v (B, S, H, D), (nU, S, D)
    tables, an (nU, S) mask and B ids < nU. Returns (B, S, H, D)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("windowed attention is self-attention over "
                         f"(B, S, H, D): q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, d = q.shape
    n_u = rope_cos.shape[0]
    if (rope_cos.shape != (n_u, s, d) or rope_sin.shape != rope_cos.shape
            or kv_valid.shape != (n_u, s) or len(table_ids) != b
            or table_ids.hi >= n_u):
        raise ValueError(f"windowed attention: tables {tuple(rope_cos.shape)}"
                         f" / {tuple(rope_sin.shape)}, mask "
                         f"{tuple(kv_valid.shape)} and {len(table_ids)} ids "
                         f"up to {table_ids.hi} do not fit {b} rows of "
                         f"({s}, {h}, {d})")
    return b, s, h, d


def _check_k9(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rope_cos: torch.Tensor, rope_sin: torch.Tensor,
              table_ids: RowIndex, kv_valid: torch.Tensor) -> None:
    """What K9's kernels take: contiguous bf16 operands, fp32 tables, a
    bool mask and int32 ids, all on one CUDA device, D in (64, 128)."""
    _check_cuda_operands(name, q, k, v)
    for t, dt in ((rope_cos, torch.float32), (rope_sin, torch.float32),
                  (kv_valid, torch.bool), (table_ids.tensor, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} kernel: tables, mask and ids must be "
                             f"contiguous {dt} on {q.device}, got {t.dtype} "
                             f"on {t.device}")
    _check_aligned(name, rope_cos, rope_sin)


def flash_windowed_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: Optional[float],
                             rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                             table_ids: RowIndex,
                             kv_valid: torch.Tensor) -> torch.Tensor:
    """Uniform-window attention: q, k, v (B, S, H, D) with B = batch *
    windows; rope_cos/rope_sin (nU, S, D) fp32 deduplicated per-window
    tables; kv_valid (nU, S) bool; table_ids: B ids < nU, window row ->
    table/mask (a RowIndex, checked on the host and uploaded once). Returns
    (B, S, H, D); scale defaults to D**-0.5.

    CPU tensors take the plain version. CUDA tensors launch kernel K9 (its
    pre-pass with the windows' tables, then the attention step over each
    window's live key tiles), or raise on what it does not take: contiguous
    bf16 q/k/v and fp32 tables, a bool mask, ids on the same device, D in
    (64, 128). Inputs that need a gradient while grad mode is on are
    refused on every device: `flash_windowed_attention_grad` carries
    one."""
    _build.refuse_grad("windowed attention", q, k, v, rope_cos, rope_sin)
    b, s, h, d = _check_windowed(q, k, v, rope_cos, rope_sin, table_ids,
                                 kv_valid)
    if q.device.type == "cpu":
        return flash_windowed_attention_plain(q, k, v, scale, rope_cos,
                                              rope_sin, table_ids, kv_valid)
    _check_k9("flash_windowed_attention", q, k, v, rope_cos, rope_sin,
              table_ids, kv_valid)
    # q-hat and k-hat: each window roped by its table (q times
    # scale*log2e), bf16
    scratch = torch.empty((2, b, s, h, d), dtype=q.dtype, device=q.device)
    out = torch.empty_like(q)
    err = _build.kernel_library().lib.seedvr2_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rope_cos.data_ptr(),
        rope_sin.data_ptr(), kv_valid.data_ptr(), table_ids.tensor.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), b, s, s, h, d, s, s,
        _qscale(scale, d), _stream(q))
    _build.check(err, "seedvr2_flash_attention")
    flash_windowed_attention.launches += 1
    return out


flash_windowed_attention.launches = 0
flash_windowed_attention.launches_lse = 0


def flash_windowed_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor,
                                       scale: Optional[float],
                                       rope_cos: torch.Tensor,
                                       rope_sin: torch.Tensor,
                                       table_ids: RowIndex,
                                       kv_valid: torch.Tensor):
    """Plain version of K9's training launch: (flash_windowed_attention_plain
    (...), lse), lse (B, H, S) fp32 the log2-domain log-sum-exp of each
    row's scores over its window's valid keys, from q and k roped by the
    window's table (q times scale*log2e), each rounded to q's dtype as K9's
    pre-pass rounds q-hat and k-hat."""
    ids = table_ids.tensor.to(q.device)
    q_hat = norm_rope_plain(q, rope_cos, rope_sin, None,
                            _qscale(scale, q.shape[-1]), ids)
    k_hat = norm_rope_plain(k, rope_cos, rope_sin, ids=ids)
    out = flash_windowed_attention_plain(q, k, v, scale, rope_cos, rope_sin,
                                         table_ids, kv_valid)
    return out, _lse_plain(q_hat, k_hat,
                           _window_keys(kv_valid, table_ids, q.device))


def flash_windowed_attention_lse(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, scale: Optional[float],
                                 rope_cos: torch.Tensor,
                                 rope_sin: torch.Tensor, table_ids: RowIndex,
                                 kv_valid: torch.Tensor):
    """K9's training launch: (out, lse) with out as flash_windowed_attention
    and lse (B, H, S) fp32 each row's log-sum-exp of its scores over its
    window's valid keys (log2 domain), every row written: what the dq and
    dk/dv kernels of K9's backward read.

    CPU tensors take the plain version. CUDA tensors launch K9 (its
    pre-pass, then the step's MASKED LSE instantiation, which also stores
    m + log2(l) per row; the serving launch keeps the other one), counted
    in flash_windowed_attention.launches and .launches_lse, or raise on
    what K9 does not take. Refuses inputs that need a gradient, as K9
    does."""
    _build.refuse_grad("windowed attention", q, k, v, rope_cos, rope_sin)
    b, s, h, d = _check_windowed(q, k, v, rope_cos, rope_sin, table_ids,
                                 kv_valid)
    if q.device.type == "cpu":
        return flash_windowed_attention_lse_plain(
            q, k, v, scale, rope_cos, rope_sin, table_ids, kv_valid)
    _check_k9("flash_windowed_attention", q, k, v, rope_cos, rope_sin,
              table_ids, kv_valid)
    scratch = torch.empty((2, b, s, h, d), dtype=q.dtype, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _build.kernel_library().lib.seedvr2_flash_attention_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rope_cos.data_ptr(),
        rope_sin.data_ptr(), kv_valid.data_ptr(), table_ids.tensor.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h, d,
        _qscale(scale, d), _stream(q))
    _build.check(err, "seedvr2_flash_attention_lse")
    flash_windowed_attention.launches += 1
    flash_windowed_attention.launches_lse += 1
    return out, lse


# ------------------------------------------------------------ K9 backward


def windowed_backward_dq_plain(q_hat: torch.Tensor, k_hat: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, lse: torch.Tensor,
                               kv_valid: torch.Tensor, table_ids: RowIndex):
    """Plain version of K9's dq kernel: (dq_acc fp32 (B, S, H, D), delta
    (B, H, S) fp32) as attention_backward_dq_plain's, over each window
    row's valid keys (kv_valid[table_ids]) in place of the first kv_len;
    every q row counts (the rows the caller crops arrive with dO = 0).
    q_hat, k_hat: K9's pre-pass output; out, dout (B, S, H, D); lse from
    K9's training launch."""
    b, s, h, d = q_hat.shape
    return _dq_plain(q_hat, k_hat, v, out, dout.float().reshape(b, s, h, d),
                     lse, _window_keys(kv_valid, table_ids, q_hat.device))


def windowed_backward_dkdv_plain(q_hat: torch.Tensor, k_hat: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor,
                                 kv_valid: torch.Tensor,
                                 table_ids: RowIndex):
    """Plain version of K9's dk/dv kernel: (dk_acc fp32 (B, S, H, D), dv in
    v's dtype) over each window row's valid keys; a masked key gets zero."""
    b, s, h, d = q_hat.shape
    return _dkdv_plain(q_hat, k_hat, v, dout.float().reshape(b, s, h, d),
                       lse, delta,
                       _window_keys(kv_valid, table_ids, q_hat.device))


def windowed_rope_backward_plain(dq_acc: torch.Tensor, dk_acc: torch.Tensor,
                                 rope_cos: torch.Tensor,
                                 rope_sin: torch.Tensor, table_ids: RowIndex,
                                 gq: float, gk: float,
                                 dtype=torch.bfloat16):
    """Plain version of K9's pre-pass backward (the rope backward by window
    id): (rot^T(gq * dq_acc), rot^T(gk * dk_acc)) in `dtype`, each row by
    the table its window id picks (rot^T(g) = g * cos - rotate_half(g *
    sin)); gq = the scale, gk = ln2 turn dQ-hat and dK-hat into the roped
    rows' gradients. K9's tables are plan constants: no table gradient."""
    ids = table_ids.tensor.to(dq_acc.device).long()
    c = rope_cos[ids].float()[:, :, None, :]
    sn = rope_sin[ids].float()[:, :, None, :]
    outs = []
    for acc, g in ((dq_acc, gq), (dk_acc, gk)):
        gr = acc.float() * g
        outs.append((gr * c - rotate_half_full(gr * sn)).to(dtype))
    return tuple(outs)


def flash_windowed_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                            v: torch.Tensor,
                                            scale: Optional[float],
                                            rope_cos: torch.Tensor,
                                            rope_sin: torch.Tensor,
                                            table_ids: RowIndex,
                                            kv_valid: torch.Tensor,
                                            out: torch.Tensor,
                                            dout: torch.Tensor):
    """Plain version of K9's backward, the kernels' parts in their order
    (q-hat and k-hat kept in fp32, so the rows' lse is that of their fp32
    scores, formed here): (dq, dk, dv) in q's, k's and v's dtypes."""
    b, s, h, d = q.shape
    ids = table_ids.tensor.to(q.device)
    keep = _window_keys(kv_valid, table_ids, q.device)
    sc = d ** -0.5 if scale is None else scale
    q_hat = norm_rope_plain(q.float(), rope_cos, rope_sin, None, sc * _LOG2E,
                            ids)
    k_hat = norm_rope_plain(k.float(), rope_cos, rope_sin, ids=ids)
    lse = _lse_plain(q_hat, k_hat, keep)
    do = dout.float().reshape(b, s, h, d)
    dq, delta = _dq_plain(q_hat, k_hat, v, out, do, lse, keep)
    dk, dv = _dkdv_plain(q_hat, k_hat, v, do, lse, delta, keep)
    dqr, dkr = windowed_rope_backward_plain(dq, dk, rope_cos, rope_sin,
                                            table_ids, sc, _LN2, torch.float32)
    return dqr.to(q.dtype), dkr.to(k.dtype), dv


def _check_k9_bwd(name: str, lse: torch.Tensor, kv_valid: torch.Tensor,
                  table_ids: RowIndex, *rows: torch.Tensor):
    """What K9's backward kernels take: bf16 (B, S, H, D) contiguous rows
    (the first sets the shape), lse (B, H, S) fp32, an (nU, S) bool mask
    and B int32 ids < nU on the rows' CUDA device."""
    x = rows[0]
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x.device}")
    b, s, h, d = x.shape
    for t in rows:
        _check_rows(name, t, (b, s, h, d), torch.bfloat16, x.device)
    _check_rows(name, lse, (b, h, s), torch.float32, x.device)
    if (kv_valid.dtype != torch.bool or kv_valid.dim() != 2
            or kv_valid.shape[1] != s or not kv_valid.is_contiguous()
            or kv_valid.device != x.device):
        raise ValueError(f"{name}: the mask must be a contiguous (nU, {s}) "
                         f"bool on {x.device}")
    _check_ids(table_ids, b, kv_valid.shape[0], x.device)
    if d not in _HEAD_DIMS or b > 65535 or h > 65535:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}, or grid "
                         "too large")
    return b, s, h, d


def windowed_backward_dq(q_hat: torch.Tensor, k_hat: torch.Tensor,
                         v: torch.Tensor, out: torch.Tensor,
                         dout: torch.Tensor, lse: torch.Tensor,
                         kv_valid: torch.Tensor, table_ids: RowIndex):
    """K9's dq kernel (plain version on the CPU): (dq_acc, delta) as
    windowed_backward_dq_plain, from the training launch's lse. On a card:
    contiguous bf16 (B, S, H, D) q_hat, k_hat, v, out, dout; the tiles as
    backward_plan(B, S, H, S) says; each block walks only its window's
    live key tiles."""
    if q_hat.device.type == "cpu":
        return windowed_backward_dq_plain(q_hat, k_hat, v, out, dout, lse,
                                          kv_valid, table_ids)
    name = "windowed backward dq"
    b, s, h, d = _check_k9_bwd(name, lse, kv_valid, table_ids, q_hat, k_hat,
                               v, out, dout)
    plan = backward_plan(b, s, h, s, _sm_count(q_hat.device))
    dq = torch.empty((b, s, h, d), dtype=torch.float32, device=q_hat.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q_hat.device)
    err = _build.kernel_library().lib.seedvr2_win_bwd_dq(
        q_hat.data_ptr(), k_hat.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), kv_valid.data_ptr(),
        table_ids.tensor.data_ptr(), dq.data_ptr(), delta.data_ptr(), b, s, h,
        d, plan.wg, plan.blocks, _stream(q_hat))
    _build.check(err, "seedvr2_win_bwd_dq")
    windowed_backward_dq.launches += 1
    return dq, delta


windowed_backward_dq.launches = 0


def windowed_backward_dkdv(q_hat: torch.Tensor, k_hat: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           kv_valid: torch.Tensor, table_ids: RowIndex):
    """K9's dk/dv kernel (plain version on the CPU): (dk_acc fp32, dv bf16)
    as windowed_backward_dkdv_plain, from the training launch's lse and the
    dq part's delta; a block of 64 keys of which none is valid writes
    zeros."""
    if q_hat.device.type == "cpu":
        return windowed_backward_dkdv_plain(q_hat, k_hat, v, dout, lse, delta,
                                            kv_valid, table_ids)
    name = "windowed backward dk/dv"
    b, s, h, d = _check_k9_bwd(name, lse, kv_valid, table_ids, q_hat, k_hat,
                               v, dout)
    _check_rows(name, delta, (b, h, s), torch.float32, q_hat.device)
    plan = backward_plan(b, s, h, s, _sm_count(q_hat.device))
    dk = torch.empty((b, s, h, d), dtype=torch.float32, device=q_hat.device)
    dv = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q_hat.device)
    err = _build.kernel_library().lib.seedvr2_win_bwd_dkdv(
        q_hat.data_ptr(), k_hat.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), kv_valid.data_ptr(),
        table_ids.tensor.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d,
        plan.kv_blocks, _stream(q_hat))
    _build.check(err, "seedvr2_win_bwd_dkdv")
    windowed_backward_dkdv.launches += 1
    return dk, dv


windowed_backward_dkdv.launches = 0


def windowed_rope_backward(dq_acc: torch.Tensor, dk_acc: torch.Tensor,
                           rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                           table_ids: RowIndex, gq: float, gk: float):
    """K9's pre-pass backward kernel (plain version on the CPU): (dq, dk)
    bf16 (B, S, H, D) as windowed_rope_backward_plain, from the dq and
    dk/dv parts' fp32 accumulators (contiguous (B, S, H, D)) and K9's
    (nU, S, D) fp32 tables."""
    if dq_acc.device.type == "cpu":
        return windowed_rope_backward_plain(dq_acc, dk_acc, rope_cos,
                                            rope_sin, table_ids, gq, gk)
    name = "windowed rope backward"
    if dq_acc.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {dq_acc.device}")
    b, s, h, d = dq_acc.shape
    for t in (dq_acc, dk_acc):
        _check_rows(name, t, (b, s, h, d), torch.float32, dq_acc.device)
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    n_u = rope_cos.shape[0]
    for t in (rope_cos, rope_sin):
        _check_table(t, (n_u, s, d), dq_acc.device)
    _check_ids(table_ids, b, n_u, dq_acc.device)
    dst = torch.empty((2, b, s, h, d), dtype=torch.bfloat16,
                      device=dq_acc.device)
    err = _build.kernel_library().lib.seedvr2_win_rope_bwd(
        dq_acc.data_ptr(), dk_acc.data_ptr(), rope_cos.data_ptr(),
        rope_sin.data_ptr(), table_ids.tensor.data_ptr(), dst[0].data_ptr(),
        dst[1].data_ptr(), b, s, h, d, float(gq), float(gk), _stream(dq_acc))
    _build.check(err, "seedvr2_win_rope_bwd")
    windowed_rope_backward.launches += 1
    return dst[0], dst[1]


windowed_rope_backward.launches = 0


def flash_windowed_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, scale: Optional[float],
                                      rope_cos: torch.Tensor,
                                      rope_sin: torch.Tensor,
                                      table_ids: RowIndex,
                                      kv_valid: torch.Tensor,
                                      out: torch.Tensor, dout: torch.Tensor,
                                      lse: torch.Tensor):
    """K9's backward from the training launch's output and lse
    (flash_windowed_attention_lse): (dq, dk, dv) (B, S, H, D). CPU tensors
    take the plain version, which keeps q-hat in fp32 and forms the lse of
    its own scores. CUDA tensors relaunch K9's pre-pass (q-hat, k-hat by
    each window's table), then the dq, dk/dv and rope backward kernels,
    which read lse (the kernels' bf16 q-hat is the forward's); what K9 does
    not take is refused as K9 refuses it."""
    b, s, h, d = _check_windowed(q, k, v, rope_cos, rope_sin, table_ids,
                                 kv_valid)
    if q.device.type == "cpu":
        return flash_windowed_attention_backward_plain(
            q, k, v, scale, rope_cos, rope_sin, table_ids, kv_valid, out,
            dout)
    _check_k9("windowed attention backward", q, k, v, rope_cos, rope_sin,
              table_ids, kv_valid)
    sc = d ** -0.5 if scale is None else scale
    q_hat, k_hat = attention_prepass(q, k, rope_cos, rope_sin, rope_cos,
                                     rope_sin, None, sc * _LOG2E, table_ids)
    dq, delta = windowed_backward_dq(q_hat, k_hat, v, out, dout, lse,
                                     kv_valid, table_ids)
    dk, dv = windowed_backward_dkdv(q_hat, k_hat, v, dout, lse, delta,
                                    kv_valid, table_ids)
    del q_hat, k_hat, delta
    dq, dk = windowed_rope_backward(dq, dk, rope_cos, rope_sin, table_ids,
                                    sc, _LN2)
    return dq, dk, dv


class WindowedAttention(torch.autograd.Function):
    """K9 with its gradient: the forward launches K9's training launch
    (flash_windowed_attention_lse; its plain version on the CPU) and saves
    q, k, v, the output and the rows' lse; the backward is
    flash_windowed_attention_backward, returning dq, dk and dv. The tables,
    the mask and the ids are the plan's constants and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, kv_valid, scale,
                table_ids):
        out, lse = flash_windowed_attention_lse(q, k, v, scale, rope_cos,
                                                rope_sin, table_ids, kv_valid)
        ctx.save_for_backward(q, k, v, rope_cos, rope_sin, kv_valid, out,
                              lse)
        ctx.args = (scale, table_ids)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rope_cos, rope_sin, kv_valid, out, lse = ctx.saved_tensors
        scale, table_ids = ctx.args
        grads = flash_windowed_attention_backward(
            q, k, v, scale, rope_cos, rope_sin, table_ids, kv_valid, out,
            dout.contiguous(), lse)
        return (*grads, None, None, None, None, None)


def flash_windowed_attention_grad(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, scale: Optional[float],
                                  rope_cos: torch.Tensor,
                                  rope_sin: torch.Tensor,
                                  table_ids: RowIndex,
                                  kv_valid: torch.Tensor) -> torch.Tensor:
    """flash_windowed_attention with a gradient for q, k and v: the kernel
    alone when none needs one (or grad mode is off), else through
    WindowedAttention. Tables that need a gradient are refused (K9's are
    the plan's constants)."""
    if not torch.is_grad_enabled():
        return flash_windowed_attention(q, k, v, scale, rope_cos, rope_sin,
                                        table_ids, kv_valid)
    if rope_cos.requires_grad or rope_sin.requires_grad:
        raise RuntimeError("windowed attention: K9's tables are the plan's "
                           "constants; its backward has no table gradient")
    if any(t.requires_grad for t in (q, k, v)):
        return WindowedAttention.apply(q, k, v, rope_cos, rope_sin, kv_valid,
                                       scale, table_ids)
    return flash_windowed_attention(q, k, v, scale, rope_cos, rope_sin,
                                    table_ids, kv_valid)

KEY_TILE = 64  # keys a tile of the Hopper attention step


def live_key_tiles(kv_valid: torch.Tensor) -> torch.Tensor:
    """(nU, S) key validity -> (nU, ceil(S / 64)) bool: the 64-key tiles of
    each window id that hold at least one valid key, the tiles K9's step
    loads and multiplies (in order) for every window row with that id."""
    n_u, s = kv_valid.shape
    pad = -s % KEY_TILE
    v = F.pad(kv_valid.bool(), (0, pad), value=False)
    return v.reshape(n_u, -1, KEY_TILE).any(dim=-1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    rope_cos: Optional[torch.Tensor] = None,
                    rope_sin: Optional[torch.Tensor] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Dense attention: q (..., Sq, H, D), k and v (..., Sk, H, D) ->
    (..., Sq, H, D); scale defaults to D**-0.5. rope_cos/rope_sin: an
    optional shared (R, D) fp32 extended table pair, R <= S, applied to q
    and k (rows past R pass through; needs Sq == Sk). kv_len: the number of
    real kv rows when the caller padded k/v (default Sk).

    CPU tensors take the plain version. CUDA tensors launch kernel K8 (with
    a table, its pre-pass, then its attention step), or raise on what it
    does not take: contiguous bf16 q/k/v and fp32 tables on one device,
    D in (64, 128)."""
    sq, sk = q.shape[-3], k.shape[-3]
    kv_len = sk if kv_len is None else kv_len
    if (k.shape != v.shape or q.shape[:-3] != k.shape[:-3]
            or q.shape[-2:] != k.shape[-2:] or not 1 <= kv_len <= sk):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} and kv_len "
                         f"{kv_len} do not fit")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("flash_attention: give both rope tables or neither")
    d = q.shape[-1]
    if rope_cos is not None and (
            sq != sk or rope_cos.dim() != 2 or rope_cos.shape[1] != d
            or rope_cos.shape[0] > sq or rope_sin.shape != rope_cos.shape):
        raise ValueError(f"flash_attention: fused rope needs Sq == Sk and "
                         f"(R <= S, {d}) tables, got Sq={sq} Sk={sk}, "
                         f"{tuple(rope_cos.shape)} / {tuple(rope_sin.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, rope_cos, rope_sin,
                                     kv_len)
    q4, k4, v4 = (t.view(-1, *t.shape[-3:]) for t in (q, k, v))
    _check_cuda_operands("flash_attention", q4, k4, v4)
    b, _, h, _ = q4.shape
    table_rows, scratch = 0, None
    if rope_cos is not None:
        table_rows = rope_cos.shape[0]
        for t in (rope_cos, rope_sin):
            _check_table(t, (table_rows, d), q.device)
        # q-hat and k-hat: roped (q times scale*log2e) bf16
        scratch = torch.empty((2, *q4.shape), dtype=q4.dtype,
                              device=q.device)
    out = torch.empty_like(q4)
    err = _build.kernel_library().lib.seedvr2_flash_attention(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
        None if rope_cos is None else rope_cos.data_ptr(),
        None if rope_sin is None else rope_sin.data_ptr(), None, None,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), b,
        sq, sk, h, d, kv_len, table_rows, _qscale(scale, d), _stream(q))
    _build.check(err, "seedvr2_flash_attention")
    flash_attention.launches += 1
    return out.reshape(q.shape)


flash_attention.launches = 0
