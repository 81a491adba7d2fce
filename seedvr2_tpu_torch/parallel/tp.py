"""Inference tensor parallelism of the NaDiT.

Port of seedvr2_tpu.parallel.tp. The weights shard over the mesh's tp axis
(parallel/mesh.py): attention heads for qkv / proj_out, the hidden dim for
the mlp. Each rank holds its slice of every block's projections, and the
forward (models/dit/nadit.py with `tp`) runs on its local heads and hidden
columns with one fp32 all-reduce after each row-sharded projection
(ops/layers.linear's `reduce`): two a sublayer pair, of the (B, L, D)
activations. Window attention is parallel over heads (rope tables and
qk-norm weights are per head_dim, not per head), so each rank runs the
attention kernel on its local heads with no communication.

Weight layout: the port stores a projection (N, K) = (out, in). The packed
qkv projection orders its N as (3, H, Dh), so a contiguous slice of rows
would split q / k / v, not heads: `permute_qkv_cols` reorders N to (tp, 3,
H/tp, Dh), so rank d's slice is its own heads' packed (3, Hloc, Dh) block
and the packed kernel runs unchanged with Hloc heads. proj_out's K and the
mlp hidden are head- / column-major and shard without permutation.

The trainer (parallel/train.py) computes on the same slices:
`local_training_dit` is a rank's NaDiT at those shapes on `meta`, whose
weights the trainer binds from its pieces block by block; only nn.Linear
trees train.

Every serving layout shards: nn.Linear, W8A8Linear (its per-out scales with
the rows it keeps), Q8Linear and AffineLinear (their per-32-group tables
with the weight: along N for a column shard, along K for a row shard). The
w8a8 swiglu's gate and up, which the port joins into one (Na + Nb, K)
weight, are sharded apart and joined again, so a rank's joint weight is
[gate_local; up_local].
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.dit.nadit import NaDiT
from ..ops.int8_matmul import W8A8Linear, fuse_gate_up
from ..ops.quant_matmul import GROUP, AffineLinear, Q8Linear
from .mesh import Mesh

# each layout's (N, K) weight, its per-out vectors (slice with N on a
# column shard, replicate on a row shard) and its per-32-group tables (N,
# K/32) (slice with the weight)
_LAYOUTS = {nn.Linear: ("weight", ("bias",), ()),
            W8A8Linear: ("w8a8", ("ws", "bias"), ()),
            Q8Linear: ("q8", ("bias",), ("scales",)),
            AffineLinear: ("qa", ("bias",), ("s", "m"))}


def permute_qkv_cols(arr, heads: int, head_dim: int, tp: int):
    """Reorder the qkv out-dim (3, H, Dh) -> (tp, 3, H/tp, Dh) so the
    tp-contiguous column slice of chip d is exactly its heads' packed
    (3, Hloc, Dh) block. Works on the last axis of weights (K, 3HD) and
    biases (3HD,). A copy of the JAX package's, pinned equal by test."""
    hloc = heads // tp
    lead = arr.shape[:-1]
    x = arr.reshape(*lead, 3, tp, hloc, head_dim)
    order = tuple(range(len(lead)))
    x = x.transpose(*order, len(lead) + 1, len(lead), len(lead) + 2,
                    len(lead) + 3)
    return x.reshape(*lead, 3 * heads * head_dim)


def qkv_row_order(cfg, tp: int) -> np.ndarray:
    """The order tp_shard_dit puts a qkv projection's rows (its out-dim)
    in before cutting them tp ways."""
    return permute_qkv_cols(np.arange(3 * cfg.heads * cfg.head_dim),
                            cfg.heads, cfg.head_dim, tp)


def _layout(layer: nn.Module):
    for cls, fields in _LAYOUTS.items():
        if isinstance(layer, cls):
            return fields
    return None


def _proj_ok(layer: nn.Module, tp: int, shard_rows: bool,
             on_card: bool) -> bool:
    """Can this projection shard tp ways? The sharded dim must divide; a
    row shard of a grouped layout (Q8Linear, AffineLinear) must split its
    per-32-group tables evenly along K. On a card the local product must be
    one the layout's kernel takes: K3 (W8A8Linear) needs the local K % 32
    and N % 8 (16-byte alignment holds: every shard is a fresh tensor), K6
    / K7 the local K % 32 and an even N. The JAX package asks the local
    extent % 128 of its TPU kernels instead."""
    fields = _layout(layer)
    if fields is None:
        return False
    n, k = getattr(layer, fields[0]).shape
    dim = k if shard_rows else n
    if dim % tp:
        return False
    if isinstance(layer, nn.Linear):
        return True
    if shard_rows and (k // GROUP) % tp:
        return False
    if on_card:
        kl, nl = (k // tp, n) if shard_rows else (k, n // tp)
        need_n = 8 if isinstance(layer, W8A8Linear) else 2
        if kl % 32 or nl % need_n:
            return False
    return True


def _mlp_projs(mlp: nn.Module):
    """(name, layer) of an mlp's projections: proj_in_gate (3B swiglu),
    proj_in, proj_out."""
    return [(name, layer) for name, layer in mlp.named_children()
            if name in ("proj_in_gate", "proj_in", "proj_out")]


def tp_compatible(model: NaDiT, tp: int, device=None) -> bool:
    """Heads and mlp hidden divisible by tp, and every sharded projection
    of every block splittable tp ways in its serving layout (dense, w8a8,
    q8, affine). device: where the model will serve (default where its
    parameters are); on a card the local products must suit the kernels
    (_proj_ok)."""
    if tp <= 1 or model.cfg.heads % tp:
        return False
    if device is None:
        device = next(model.parameters(), torch.empty(0)).device
    on_card = torch.device(device).type == "cuda"
    for blk in model.blocks:
        if not all(_proj_ok(p, tp, False, on_card)
                   for p in blk.attn.proj_qkv.values()):
            return False
        if not all(_proj_ok(p, tp, True, on_card)
                   for p in blk.attn.proj_out.values()):
            return False
        for mlp in blk.mlp.values():
            for name, proj in _mlp_projs(mlp):
                if not _proj_ok(proj, tp, name == "proj_out", on_card):
                    return False
            f = _layout(mlp.proj_in)
            if getattr(mlp.proj_in, f[0]).shape[0] % tp:
                return False
    return True


def _shard(layer: nn.Module, index: int, tp: int, rows: bool,
           perm: Optional[np.ndarray] = None) -> nn.Module:
    """Rank `index`'s slice of a projection, as a new module of its layout
    with fresh (contiguous) tensors: rows=True slices K (the weight and
    its group tables; vectors replicate), else N (every field; `perm`
    reorders N first)."""
    wname, vecs, tables = _layout(layer)
    n, k = getattr(layer, wname).shape

    def cut(t: torch.Tensor, along_k: bool) -> torch.Tensor:
        if t is None:
            return None
        if rows:
            if not along_k:
                return t.detach().clone()
            step = t.shape[1] // tp
            return t[:, index * step:(index + 1) * step].detach().clone()
        if perm is not None:
            t = t[torch.as_tensor(perm, device=t.device)]
        step = n // tp
        return t[index * step:(index + 1) * step].detach().clone()

    weight = cut(getattr(layer, wname), True)
    parts = {f: cut(getattr(layer, f), True) for f in tables}
    vec = {f: cut(getattr(layer, f), False) for f in vecs}
    if isinstance(layer, nn.Linear):
        with torch.device("meta"):
            out = nn.Linear(weight.shape[1], weight.shape[0],
                            bias=vec["bias"] is not None)
        grad = layer.weight.requires_grad
        out.weight = nn.Parameter(weight, requires_grad=grad)
        if vec["bias"] is not None:
            out.bias = nn.Parameter(vec["bias"], requires_grad=grad)
        return out
    if isinstance(layer, W8A8Linear):
        return W8A8Linear(weight, vec["ws"], vec["bias"])
    if isinstance(layer, Q8Linear):
        return Q8Linear(weight, parts["scales"], vec["bias"])
    return AffineLinear(weight, parts["s"], parts["m"], vec["bias"])


@torch.no_grad()
def tp_shard_dit(model: NaDiT, mesh: Mesh) -> NaDiT:
    """Replace every block's projections in place by this rank's tp slices
    (qkv rows permuted by head block, proj_out's K, the mlp's proj_in /
    gate rows and proj_out's K), on the device they are on. The IO
    projections, norms and modulation tables stay whole. Call
    tp_compatible first. Returns the model."""
    tp = mesh.shape["tp"]
    index = mesh.coords()["tp"]
    perm = qkv_row_order(model.cfg, tp)
    for blk in model.blocks:
        for b, layer in list(blk.attn.proj_qkv.items()):
            blk.attn.proj_qkv[b] = _shard(layer, index, tp, False, perm)
        for b, layer in list(blk.attn.proj_out.items()):
            blk.attn.proj_out[b] = _shard(layer, index, tp, True)
        for mlp in blk.mlp.values():
            for name, layer in _mlp_projs(mlp):
                setattr(mlp, name, _shard(layer, index, tp,
                                          name == "proj_out"))
            gate = getattr(mlp, "proj_in_gate", None)
            if isinstance(gate, W8A8Linear) and isinstance(mlp.proj_in,
                                                           W8A8Linear):
                fuse_gate_up(gate, mlp.proj_in)
    return model


def local_training_dit(cfg, mesh: Optional[Mesh],
                       dtype=torch.bfloat16) -> NaDiT:
    """A rank's NaDiT for the trainer, on `meta`: cfg's modules in `dtype`,
    every block projection at this rank's tp slice shape (tp_shard_dit's
    cut of a meta model, so no tensor is made). The trainer binds each
    module's weights (views of its gathered buckets) before the module
    runs. Raises when the mesh's tp does not divide the heads, the mlp
    hidden and every sharded projection (tp_compatible)."""
    with torch.device("meta"):
        model = NaDiT(cfg, dtype=dtype)
    tp = 1 if mesh is None else mesh.shape.get("tp", 1)
    if tp > 1:
        if not tp_compatible(model, tp, "meta"):
            raise ValueError(f"{cfg.heads} heads and the mlp hidden of this "
                             f"NaDiT do not split over {tp} tp ranks")
        tp_shard_dit(model, mesh)
    return model
