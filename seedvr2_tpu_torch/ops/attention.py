"""Attention primitives (port of seedvr2_tpu.ops.attention).

 - `attention_xla`: the dense composition: fp32 logits from the operands'
   exact products, fp32 softmax, probabilities rounded to v's dtype,
   fp32-accumulated p@v rounded to q's dtype. The plain versions of the
   attention kernels (K1, K8, K9) are built on it.
 - `attention`: the dispatcher of the uniform window plan (table_ids given:
   kernel K9, through `flash_windowed_attention_grad`, which carries K9's
   hand-written gradient when q, k or v needs one) and of dense attention
   (kernel K8); the grouped plan calls K1 directly
   (ops.flash_attention.packed_window_attention_grad).

The attention mode (the CLI's --attention_mode, JAX's set_attention_mode
without its process-wide global: the runner holds the mode and hands it to
each forward):
 - "flash", the default: the kernels K1, K8 and K9;
 - "xla" (alias "sdpa"; "flash_attn" is an alias of "flash"): the
   counterpart of JAX's XLA attention, a lane the user opts into and
   nothing else chooses: q/k RMS norm and rope in fp32 in torch, rounded to
   the operands' dtype, then torch's scaled_dot_product_attention. On the
   grouped plan (`packed_attention_sdpa`) and in dense attention the keys
   at or past kv_len are sliced off, so SDPA runs unmasked; on the uniform
   plan (`attention(..., mode="xla")` with table_ids) each window's invalid
   keys are masked by its validity row.
"""

from typing import Optional

import torch
import torch.nn.functional as F

ATTENTION_MODES = ("flash", "xla")
# the reference CLI's names (JAX ops/attention.py set_attention_mode)
_ALIASES = {"sdpa": "xla", "flash_attn": "flash"}


def resolve_attention_mode(mode: str) -> str:
    """"flash" or "xla" for a mode name or one of its aliases."""
    mode = _ALIASES.get(mode, mode)
    if mode not in ATTENTION_MODES:
        raise ValueError(f"attention mode {mode!r}; known: "
                         f"{ATTENTION_MODES + tuple(_ALIASES)}")
    return mode


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (..., Sq, H, D); k, v: (..., Sk, H, D). bias: additive logit bias
    broadcastable to (..., H, Sq, Sk)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("...hqk,...khd->...qhd", probs.float(), v.float())
    return out.to(q.dtype)


def _norm_rope(x: torch.Tensor, cos: Optional[torch.Tensor],
               sin: Optional[torch.Tensor],
               eps: Optional[float] = None) -> torch.Tensor:
    """x (B, S, H, D): RMS-normed over D when eps is given, then rotated by
    interleaved rotate-half RoPE with fp32 tables broadcastable to (B, S, D)
    (JAX packed_attention's norm / rope and apply_rope_ext), all in fp32,
    rounded back to x's dtype."""
    from ..models.dit.rope import rotate_half_full

    z = x.float()
    if eps is not None:
        z = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + eps)
    if cos is not None:
        c, s = cos.float().unsqueeze(-2), sin.float().unsqueeze(-2)
        z = z * c + rotate_half_full(z) * s
    return z.to(x.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
          keep: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, S, H, D) operands through torch's scaled_dot_product_attention;
    keep: bool (B or 1, Sk) keys to attend, or None for all."""
    mask = None if keep is None else keep[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale).transpose(1, 2)


def packed_attention_sdpa(qkv: torch.Tensor, heads: int, d: int, cos_q,
                          sin_q, cos_k, sin_k, eps: float,
                          kv_len: int) -> torch.Tensor:
    """The grouped plan's attention in the "xla" mode: qkv (B, S, 3*H*D),
    tables (S, D) fp32 carrying the qk-norm weights -> (B, S, H*D), keys at
    or past kv_len left out; K1's function without K1. The pad keys are
    sliced off rather than masked (the same softmax), so SDPA needs no
    mask and may take its fastest backend."""
    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, heads, d)
    q = _norm_rope(x[:, :, 0], cos_q, sin_q, eps)
    k = _norm_rope(x[:, :kv_len, 1], cos_k[:kv_len], sin_k[:kv_len], eps)
    out = _sdpa(q, k, x[:, :kv_len, 2], d ** -0.5, None)
    return out.reshape(b, s, heads * d)


def _attention_sdpa(q, k, v, scale, rope_cos, rope_sin, table_ids, kv_valid,
                    kv_len):
    """attention()'s "xla" mode (JAX attention's non-flash branch)."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    keep = None
    if table_ids is not None:
        ids = table_ids.tensor.to(q.device).long()
        cos_b, sin_b = rope_cos[ids], rope_sin[ids]  # (B, S, D)
        q = _norm_rope(q, cos_b, sin_b)
        k = _norm_rope(k, cos_b, sin_b)
        keep = kv_valid[ids]
    elif rope_cos is not None:
        s = q.shape[-3]
        cos, sin = rope_cos, rope_sin
        if cos.shape[0] < s:  # identity rows for caller-padded positions
            cos = F.pad(cos, (0, 0, 0, s - cos.shape[0]), value=1.0)
            sin = F.pad(sin, (0, 0, 0, s - sin.shape[0]))
        q = _norm_rope(q, cos, sin)
        k = _norm_rope(k, cos, sin)
    if kv_len is not None:  # the caller's pad keys, sliced off
        k, v = k[..., :kv_len, :, :], v[..., :kv_len, :, :]
    out = _sdpa(q, k, v, scale, keep)
    if keep is not None:
        # a row with no key to attend (a uniform window whose validity row
        # marks none) is NaN, as in JAX's attention_xla (softmax over only
        # -inf logits), where SDPA gives zeros
        out = out.masked_fill(~keep.any(dim=-1)[:, None, None, None],
                              float("nan"))
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None, rope_cos=None, rope_sin=None,
              table_ids=None, kv_valid=None, kv_len: Optional[int] = None,
              use_kernels: bool = True, mode: str = "flash") -> torch.Tensor:
    """q (..., Sq, H, D), k and v (..., Sk, H, D) -> (..., Sq, H, D).

    rope_cos/rope_sin: extended rope tables applied to q and k in fp32, in
    one of two forms:
     - shared (S, D), the same table for every row (dense, kernel K8);
     - per window (nU, S, D) deduplicated tables with `table_ids` (an
       ops.gather.RowIndex of B ids) mapping rows to ids and `kv_valid`
       (nU, S) bool masking padded kv slots (the uniform window partition,
       kernel K9).
    kv_len: the number of real kv rows when the caller padded k/v (dense).

    The kernels' wrappers run their plain versions on CPU tensors and
    launch the kernels on CUDA tensors (or raise); use_kernels=False runs
    the plain versions on any device. mode "xla" (or an alias) takes the
    SDPA lane instead of a kernel, on any device."""
    from . import flash_attention as fa

    if resolve_attention_mode(mode) == "xla":
        return _attention_sdpa(q, k, v, scale, rope_cos, rope_sin, table_ids,
                               kv_valid, kv_len)

    if table_ids is not None:
        fn = (fa.flash_windowed_attention_grad if use_kernels
              else fa.flash_windowed_attention_plain)
        return fn(q, k, v, scale, rope_cos, rope_sin, table_ids, kv_valid)
    fn = fa.flash_attention if use_kernels else fa.flash_attention_plain
    return fn(q, k, v, scale, rope_cos, rope_sin, kv_len)
