"""Attention primitives (port of seedvr2_tpu.ops.attention).

 - `attention_xla`: the dense composition: fp32 logits from the operands'
   exact products, fp32 softmax, probabilities rounded to v's dtype,
   fp32-accumulated p@v rounded to q's dtype. The plain versions of the
   attention kernels (K1, K8, K9) are built on it.
 - `attention`: the dispatcher of the uniform window plan (table_ids given:
   kernel K9) and of dense attention (kernel K8); the grouped plan calls K1
   directly (ops.flash_attention.packed_window_attention).
"""

from typing import Optional

import torch


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None, rope_cos=None, rope_sin=None,
              table_ids=None, kv_valid=None, kv_len: Optional[int] = None,
              use_kernels: bool = True) -> torch.Tensor:
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
    the plain versions on any device."""
    from . import flash_attention as fa

    if table_ids is not None:
        fn = (fa.flash_windowed_attention if use_kernels
              else fa.flash_windowed_attention_plain)
        return fn(q, k, v, scale, rope_cos, rope_sin, table_ids, kv_valid)
    fn = fa.flash_attention if use_kernels else fa.flash_attention_plain
    return fn(q, k, v, scale, rope_cos, rope_sin, kv_len)
