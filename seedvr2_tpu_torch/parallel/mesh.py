"""The device mesh of the port's serving and training parallelism.

Port of seedvr2_tpu.parallel.mesh in PyTorch's idiom. JAX runs one SPMD
program over a named mesh of chips; the port runs one process per device
(`torchrun`, or the CLI's own launcher) and lays the processes of a
torch.distributed world out as a mesh of named axes, row-major, as JAX
reshapes its device list:

 - dp: data parallel, independent batches and VAE tiles; the trainer's
   batch rows (`batch_sharding`);
 - fsdp: parameter sharding, the trainer's: every parameter of rank >= 2
   keeps 1/fsdp of one dim here, its optimizer moments and gradient with
   it, and each block's weights are gathered only while that block runs
   (parallel/train.py);
 - tp: tensor parallel, the DiT's attention heads and mlp hidden
   (parallel/tp.py), in serving and in training alike.

Two parameter layouts. `param_sharding` is JAX's rule, pinned to it by
test: fsdp over the JAX in-dim, tp over the JAX out-dim of every tensor of
rank >= 2. The trainer lays its pieces out by `train_sharding` instead, the
layout its compute reads: tp cuts the dims tp.py's slices cut (read from
the shapes of its local_training_dit: the qkv and mlp in-projections' rows,
the qkv rows permuted by head block; the out-projections' columns) and
nothing else, and fsdp cuts
the dim tp leaves whole (the JAX in-dim, or dim 0 where tp took it). So a
rank stores exactly the pieces it computes with, and no collective moves
weights for tp. Checkpoints hold whole tensors, so either layout restores
onto any mesh.

`Mesh` answers what the runner asks of JAX's mesh (`shape` as a dict,
`axis_names`) and holds one process group a line of each axis, made with
`torch.distributed.new_group` on the backend asked for (NCCL between
cards, gloo on the CPU, and gloo named explicitly where two ranks share one
card, which NCCL refuses), each bounded by COLLECTIVE_TIMEOUT. Every
collective runs in parallel/comm.py.

A sharding spec is a tuple with one entry a dim of the tensor as the port
holds it: an axis name (that dim cut in equal contiguous pieces over the
axis, piece i on the rank at index i) or None (whole). `shard` cuts this
rank's piece; parallel/comm.gather_shards puts the pieces back together.
"""

import os
from dataclasses import dataclass, field
from datetime import timedelta
from itertools import product
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# How long a collective on a mesh's groups waits for a partner before it
# raises, so that the partners of a rank that failed outside a collective
# (an exception inside a tp forward, say) fail too instead of waiting.
# NCCL's own default, which gloo's 30 minutes would otherwise exceed; it
# outlasts the longest legitimate wait at a collective by far: a dp rank
# without an item waits out its partners' wave, one DiT step and its VAE
# phases, seconds on the card, and a trainer's ranks wait out one rank
# writing the checkpoint.
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def factorize(n: int, ways: int = 3) -> Sequence[int]:
    """Split n into `ways` near-equal power factors (largest first)."""
    factors = [1] * ways
    i = 0
    remaining = n
    primes = []
    d = 2
    while remaining > 1:
        while remaining % d == 0:
            primes.append(d)
            remaining //= d
        d += 1
    for p in sorted(primes, reverse=True):
        factors[i % ways] *= p
        i += 1
    return sorted(factors, reverse=True)


@dataclass(eq=False)
class Mesh:
    """World ranks `ranks` laid out row-major over `axis_names` with extents
    `shape`; `rank` is this process's world rank (None outside a process
    group: a one-rank mesh). `groups` holds the process groups of the lines
    this rank lies on, keyed by their ranks, and of the whole mesh."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    ranks: Tuple[int, ...]
    rank: int = 0
    groups: Dict[Tuple[int, ...], object] = field(default_factory=dict,
                                                   repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of a world rank (default this one)."""
        pos = self.ranks.index(self.rank if rank is None else rank)
        idx = np.unravel_index(pos, [self.shape[a] for a in self.axis_names])
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def rank_at(self, **coords) -> int:
        """The world rank at the given axis indices (missing axes: 0)."""
        idx = [coords.get(a, 0) for a in self.axis_names]
        pos = np.ravel_multi_index(idx, [self.shape[a]
                                         for a in self.axis_names])
        return self.ranks[int(pos)]

    def line(self, axis: Optional[str] = None) -> Tuple[int, ...]:
        """The world ranks that share every index of this rank but
        `axis`'s, in axis order; the whole mesh for axis None."""
        if axis is None:
            return self.ranks
        here = self.coords()
        return tuple(self.rank_at(**{**here, axis: i})
                     for i in range(self.shape.get(axis, 1)))

    def group(self, axis: Optional[str] = None):
        """The process group of line(axis); None for a line of one rank,
        which needs no collective."""
        ranks = self.line(axis)
        return None if len(ranks) == 1 else self.groups[ranks]


def make_mesh(n_devices: Optional[int] = None,
              axis_names=("dp", "fsdp", "tp"),
              shape: Optional[Sequence[int]] = None,
              backend: Optional[str] = None) -> Mesh:
    """Mesh over the first `n_devices` ranks of the torch.distributed world
    (default the whole world), as JAX's takes the first n devices, over
    JAX's default axes (dp, fsdp, tp). With shape None the count is
    factorized near-equally over the axes; an explicit shape pins each
    axis' extent (the CLI's --tensor_parallel -> (dp, tp)) and must lay out
    n_devices exactly, as in JAX. backend: the process groups' backend
    (None: the world's). Every rank of the world calls this with the same
    arguments (process groups are made collectively); a rank outside the
    mesh gets it with `member` False. Without an initialised process group
    only a one-rank mesh is possible. A collective on the mesh's groups
    waits at most COLLECTIVE_TIMEOUT for a partner, then raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if shape is None:
        shape = factorize(n, len(axis_names))
    elif len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not lay out "
                         f"{n} devices over axes {tuple(axis_names)}")
    if n > world:
        raise ValueError(f"a mesh of {n} ranks does not fit a world of "
                         f"{world}")
    ranks = tuple(range(n))
    mesh = Mesh(tuple(axis_names), dict(zip(axis_names, map(int, shape))),
                ranks, dist.get_rank() if dist.is_initialized() else 0)
    if n == 1:
        return mesh
    grid = np.asarray(ranks).reshape(tuple(shape))
    lines = [ranks]
    for ax in range(len(axis_names)):
        if shape[ax] == 1:
            continue
        rest = [range(s) for i, s in enumerate(shape) if i != ax]
        for idx in product(*rest):
            sel = list(idx)
            sel.insert(ax, slice(None))
            lines.append(tuple(int(r) for r in grid[tuple(sel)]))
    # collective: every world rank makes every group once, in one order
    for line in dict.fromkeys(lines):
        group = dist.new_group(list(line), backend=backend,
                               timeout=COLLECTIVE_TIMEOUT)
        if mesh.rank in line:
            mesh.groups[line] = group
    return mesh


def param_sharding(mesh: Mesh, shape: Sequence[int]) -> Tuple:
    """The training layout of a parameter of torch shape `shape`: JAX's rule
    (seedvr2_tpu.parallel.mesh.param_sharding) on the JAX layout of the
    same tensor. Rank >= 2 shards its JAX in-dim (dim 0) over fsdp and its
    JAX out-dim (the last dim) over tp where fsdp / tp > 1 divides it;
    everything else is replicated. The port holds a linear as (out, in),
    JAX as (in, out): fsdp cuts torch dim 1, tp dim 0. 5-D and 4-D convs
    follow core.weights.state_dict_from_jax's transposes (JAX (kt, kh, kw,
    ci, co) / (kh, kw, ci, co), torch (co, ci, kt, kh, kw) / (co, ci, kh,
    kw)): fsdp cuts torch dim 2, tp dim 0. Other ranks keep JAX's
    layout."""
    fsdp = mesh.shape.get("fsdp", 1)
    tp = mesh.shape.get("tp", 1)
    n = len(shape)
    spec = [None] * n
    if n < 2:
        return tuple(spec)
    # the torch dims of JAX's dim 0 and of its last dim
    first, last = {2: (1, 0), 4: (2, 0), 5: (2, 0)}.get(n, (0, n - 1))
    if fsdp > 1 and shape[first] % fsdp == 0:
        spec[first] = "fsdp"
    if tp > 1 and shape[last] % tp == 0:
        spec[last] = "tp"
    return tuple(spec)


def train_sharding(mesh: Mesh, shape: Sequence[int],
                   local_shape: Sequence[int]) -> Tuple:
    """The trainer's layout of a NaDiT parameter of torch shape `shape`
    whose tp rank computes with `local_shape` (its shape in
    tp.local_training_dit, the one owner of the tp cuts): tp over the dim
    that shrank there, fsdp over torch dim 1 (JAX's in-dim) of a tensor of
    rank >= 2, or dim 0 where tp took dim 1, where fsdp divides it;
    everything else whole. A qkv's rows are cut in the order
    tp.qkv_row_order gives them (parallel/train.py applies it). With
    tp = 1 this is param_sharding on every NaDiT tensor."""
    fsdp = mesh.shape.get("fsdp", 1)
    spec = [None] * len(shape)
    for dim, (n, m) in enumerate(zip(shape, local_shape)):
        if m != n:
            spec[dim] = "tp"
    if fsdp > 1 and len(shape) >= 2:
        dim = 0 if spec[1] == "tp" else 1
        if shape[dim] % fsdp == 0:
            spec[dim] = "fsdp"
    return tuple(spec)


def batch_sharding(mesh: Mesh, ndim: int) -> Tuple:
    """The leading batch axis over dp, everything else whole (every mesh
    lays its batch rows out so)."""
    return ("dp",) + (None,) * (ndim - 1)


def shard(mesh: Mesh, t: torch.Tensor, spec: Sequence) -> torch.Tensor:
    """This rank's piece of `t` under `spec` (a view). A dim that its axis
    does not divide raises."""
    here = mesh.coords()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape.get(axis, 1)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {n} {axis} ranks")
        size = t.shape[dim] // n
        t = t.narrow(dim, here[axis] * size, size)
    return t


def local_rank() -> int:
    """This process's index among the processes of its host (torchrun's
    LOCAL_RANK; 0 outside a launcher)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device: str = "cuda") -> torch.device:
    """The device this rank serves on: card LOCAL_RANK modulo the visible
    cards for "cuda", the CPU for "cpu"."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())
