"""Every collective of the port's serving and training parallelism, in one
place.

Four kinds, on the tensors' own device:

 - `all_reduce_sum_`: the fp32 sum of the partial products of a
   row-sharded projection over the tp line (ops/layers.linear's `reduce`,
   made by `tp_reducer`);
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
   hold under a sharding spec (parallel/mesh.py; the trainer's fsdp / tp
   parameter pieces), bit-exact in any dtype.

All are built on torch.distributed's broadcast and all_reduce, the two
collectives that NCCL takes and that gloo also takes on CUDA tensors (gloo
stages them through the host itself), so one code path serves NCCL between
cards, gloo on the CPU, and gloo for two ranks sharing one card. A
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


def tp_reducer(mesh: Optional[Mesh]
               ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The `reduce` of the row-sharded projections under `mesh`'s tp axis
    (fp32 partials summed in place over the tp line), or None without
    tensor parallelism."""
    if mesh is None or mesh.shape.get("tp", 1) == 1:
        return None
    return lambda t: all_reduce_sum_(t, mesh, "tp")


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
    full = torch.zeros(tuple(shape), dtype=local.dtype, device=local.device)
    shard(mesh, full, spec).copy_(local)
    raw = full.view(-1).view(torch.uint8)
    for axis in axes:
        dist.all_reduce(raw, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return full


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
