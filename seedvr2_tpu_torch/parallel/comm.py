"""Every collective of the port's serving and training parallelism, in one
place.

Five kinds, on the tensors' own device:

 - the tp line of a NaDiT forward (`TPComm`, made by `tp_reducer`): the
   fp32 sum of the partial products of a row-sharded projection
   (ops/layers.linear's `reduce`), and its pair at the input of the
   column-sharded projections, which passes the activations through and
   sums their gradient over the line. Under autograd both are Functions
   (`_TPSum`: sum forward, identity back; `_TPEnter`: identity forward,
   sum back, out of place), so the trainer's backward runs on the local
   heads and hidden columns as its forward does; serving sums in place;
 - `broadcast` / `share`: results of the dp and tile waves, each computed
   by one rank, handed to every rank of the mesh; `spread` runs those
   waves for the runner, the tiled VAE and (through `wave_width`) the
   pipeline;
 - `agree_max`: a decision every rank must take alike, although each
   reaches it alone (a VAE item's tile plan, a wave's failure), so that
   no rank takes a branch with collectives that another rank skips;
   `agreed` runs a step whose failure on one rank every rank must share
   before anything more is exchanged (a tiled call's blend buffers);
 - `gather_shards`: a tensor put back together from the pieces the ranks
   hold under a sharding spec (parallel/mesh.py), bit-exact in any dtype;
   the trainer's whole parameters for checkpoints (`gather_shards.calls`
   counts them: a train step makes none);
 - `all_gather_`: the equal pieces of every rank of a line side by side:
   the trainer's gather of one block's fsdp pieces (parallel/train.py).

`all_gather_` is built on torch.distributed's all_gather_into_tensor, in
place (this rank's piece already in its row of the output), which NCCL
takes and gloo takes too, on the CPU and on CUDA tensors (gloo stages
these through the host itself; chip_smoke.py's phase 13 runs it so on the
card). The rest is built on broadcast and all_reduce, which both backends
take alike. gather_shards, which runs only for a checkpoint and may cut a
tensor over several axes, writes each rank's piece into zeros and sums
the bytes: twice the traffic of an all_gather, and bit-exact. A
broadcast first sends a small header (dtype, shape), so receivers need not
know what they receive, then the tensor's bytes as uint8: bit-exact for
every dtype, whatever the backend's reductions support.
"""

from typing import Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.partition import partition_by_size
from .mesh import Mesh, shard

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int8, torch.uint8, torch.int32, torch.int64, torch.bool)
_MAX_DIMS = 8
# a wave's outcome on one rank; the worst over the mesh is the wave's
_OK, _OOM, _FAILED = 0, 1, 2


def all_reduce_sum_(t: torch.Tensor, mesh: Optional[Mesh],
                    axis: str = "tp") -> torch.Tensor:
    """Sum `t` over this rank's line of `axis`, in place; `t` as it is on a
    line of one rank or without a mesh."""
    group = None if mesh is None else mesh.group(axis)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _TPSum(torch.autograd.Function):
    """The reduce of a row-sharded projection under autograd: the fp32
    partials summed over the tp line into a new tensor (the input, which
    autograd may hold, stays as it was); the gradient passes back
    unchanged, as every rank of the line holds the same sum."""

    @staticmethod
    def forward(ctx, t, mesh):
        return all_reduce_sum_(t.clone(), mesh, "tp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TPEnter(torch.autograd.Function):
    """The input of the column-sharded projections under autograd: passed
    through unchanged; its gradient, each rank's part from its own heads or
    hidden columns, summed over the tp line in fp32 (out of place) and
    rounded once to the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_sum_(grad.to(torch.float32, copy=True), ctx.mesh,
                                "tp")
        return total.to(grad.dtype), None


class TPComm:
    """The tp line's collectives of a NaDiT forward (models/dit/nadit.py
    `tp`). Called on a row-sharded projection's fp32 partials: their sum
    over the line (in place when no gradient flows, else `_TPSum`).
    `enter(x)`: the activation (or replicated weight) a column-sharded
    projection or a local head reads, with `_TPEnter` on it when a
    gradient flows; anything else (a PreQuantized, no gradient) as it
    is."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and t.requires_grad:
            return _TPSum.apply(t, self.mesh)
        return all_reduce_sum_(t, self.mesh, "tp")

    def enter(self, x):
        if (isinstance(x, torch.Tensor) and torch.is_grad_enabled()
                and x.requires_grad):
            return _TPEnter.apply(x, self.mesh)
        return x


def tp_reducer(mesh: Optional[Mesh]) -> Optional[TPComm]:
    """The `reduce` of the row-sharded projections under `mesh`'s tp axis
    (a TPComm: fp32 partials summed over the tp line), or None without
    tensor parallelism."""
    if mesh is None or mesh.shape.get("tp", 1) == 1:
        return None
    return TPComm(mesh)


def all_gather_(rows: torch.Tensor, mesh: Optional[Mesh],
                axis: str) -> torch.Tensor:
    """`rows` ((n, m), contiguous; n the line's extent) with row i made the
    row that the rank at index i of this rank's line of `axis` holds, every
    rank having written its own row first; in place, bit for bit in any
    dtype (the bytes are gathered)."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return rows
    line = mesh.line(axis)
    if list(line) != sorted(line):
        # a process group orders its ranks by their world rank
        raise ValueError(f"the {axis} line {line} is not in world order")
    raw = rows.view(-1).view(torch.uint8)
    n = raw.numel() // rows.shape[0]
    dist.all_gather_into_tensor(raw, raw[mesh.coords()[axis] * n:][:n],
                                group=group)
    return rows


def agree_max(values: Sequence[int], mesh: Optional[Mesh], device
              ) -> List[int]:
    """The elementwise max of the ints `values` over every rank of the
    mesh; `values` themselves without a mesh or on one rank."""
    group = None if mesh is None else mesh.group()
    if group is None:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [int(v) for v in t.tolist()]


def gather_shards(local: torch.Tensor, spec: Sequence, shape: Sequence[int],
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole tensor of `shape` of which each rank holds its piece under
    `spec` (mesh.shard's) as `local`, on every rank of the lines of the
    spec's axes. Each rank writes its piece into zeros and the bytes are
    summed as uint8 over each axis' line in turn; exactly one rank holds a
    nonzero byte at each place, so the sum is the tensor bit for bit, in
    any dtype. `local` itself when no axis of the spec spans ranks."""
    axes = [a for a in spec if a is not None and mesh is not None
            and mesh.shape.get(a, 1) > 1]
    if not axes:
        return local
    gather_shards.calls += 1
    full = torch.zeros(tuple(shape), dtype=local.dtype, device=local.device)
    shard(mesh, full, spec).copy_(local)
    raw = full.view(-1).view(torch.uint8)
    for axis in axes:
        dist.all_reduce(raw, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return full


gather_shards.calls = 0


def broadcast(t: Optional[torch.Tensor], src: int, mesh: Mesh,
              device) -> torch.Tensor:
    """The tensor world rank `src` holds (given there, None elsewhere),
    received on `device` by every rank of the mesh; on a one-rank mesh `t`
    itself."""
    group = mesh.group()
    if group is None:
        return t
    device = torch.device(device)
    head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64, device=device)
    if mesh.rank == src:
        if t.dim() > _MAX_DIMS:
            raise ValueError(f"broadcast: {t.dim()} dims > {_MAX_DIMS}")
        head[0] = _DTYPES.index(t.dtype)
        head[1] = t.dim()
        head[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    dist.broadcast(head, src, group=group)
    dtype = _DTYPES[int(head[0])]
    shape = [int(s) for s in head[2:2 + int(head[1])]]
    if mesh.rank == src:
        data = t.detach().to(device).contiguous().reshape(-1).view(torch.uint8)
    else:
        n = torch.Size(shape).numel() * torch.empty((), dtype=dtype
                                                    ).element_size()
        data = torch.empty(n, dtype=torch.uint8, device=device)
    if data.numel():
        dist.broadcast(data, src, group=group)
    if mesh.rank == src:
        return t
    return data.view(dtype).reshape(shape)


def share(local: Optional[torch.Tensor], owners: Sequence[int], mesh: Mesh,
          device) -> List[torch.Tensor]:
    """A wave's results in order: item j was computed by world rank
    owners[j] (`local` is this rank's item, None where it owns none), and
    every rank of the mesh receives every item."""
    return [broadcast(local if mesh.rank == src else None, src, mesh, device)
            for src in owners]


def wave_width(mesh: Optional[Mesh], axis: Optional[str] = None) -> int:
    """Items a wave of `spread` holds: one a rank of the whole mesh (axis
    None) or one a line of `axis` (axis "dp": one a tp group); 1 without a
    mesh."""
    if mesh is None:
        return 1
    return mesh.size if axis is None else mesh.shape.get(axis, 1)


def spread(items: Sequence, run: Callable, mesh: Optional[Mesh],
           axis: Optional[str] = None, device="cpu") -> Iterator:
    """run(item) for each item, yielded in input order, over the mesh: in
    waves of `wave_width(mesh, axis)` items, item j of a wave computed by
    the ranks at index j of `axis` (every rank of the mesh for axis None;
    for "dp" the result is taken from the tp rank 0 of the group), then
    shared with every rank. Each item runs alone, as on one rank, so the
    results are bit-equal to one rank's.

    A wave's outcome is agreed before its results are shared: when `run`
    raises on some rank, every rank raises (its own error on that rank;
    torch.cuda.OutOfMemoryError elsewhere when a rank ran out of device
    memory, so a caller's OOM retry runs on every rank alike, else
    RuntimeError), and no rank waits in a share that another rank left.
    Without a mesh, or with one item a wave, the items run here in
    turn."""
    width = wave_width(mesh, axis)
    if width == 1:
        for x in items:
            yield run(x)
        return
    if axis is None:
        owners = list(mesh.ranks)
        mine = mesh.ranks.index(mesh.rank)
    else:
        owners = [mesh.rank_at(**{axis: j}) for j in range(width)]
        mine = mesh.coords()[axis]
    for wave in partition_by_size(list(range(len(items))), width):
        local = agreed(
            (lambda i=wave[mine]: run(items[i])) if mine < len(wave)
            else (lambda: None), mesh, device, "wave")
        yield from share(local, owners[:len(wave)], mesh, device)


def agreed(run: Callable, mesh: Optional[Mesh], device, what: str = "step"):
    """run() here, its outcome agreed by every rank of the mesh before any
    rank goes on: when run raises on some rank, every rank raises (its own
    error on that rank; torch.cuda.OutOfMemoryError elsewhere when a rank
    ran out of device memory, so a caller's OOM retry runs on every rank
    alike, else RuntimeError), and no rank waits in a later collective that
    another rank left. Every rank calls it; without a mesh run() alone."""
    out, err, state = None, None, _OK
    try:
        out = run()
    except torch.cuda.OutOfMemoryError as e:
        err, state = e, _OOM
    except Exception as e:  # noqa: BLE001 - re-raised below
        err, state = e, _FAILED
    if mesh is not None:
        state = agree_max([state], mesh, device)[0]
    if err is not None:
        raise err
    if state == _OOM:
        raise torch.cuda.OutOfMemoryError(
            f"another rank of the mesh ran out of device memory in this "
            f"{what}")
    if state == _FAILED:
        raise RuntimeError(f"another rank of the mesh failed in this {what}")
    return out
