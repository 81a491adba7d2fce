"""Dense attention composition (port of seedvr2_tpu.ops.attention.
attention_xla): fp32 logits from the operands' exact products, fp32 softmax,
probabilities rounded to v's dtype, fp32-accumulated p@v rounded to q's
dtype. The plain version of kernel K1 is built on it."""

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
