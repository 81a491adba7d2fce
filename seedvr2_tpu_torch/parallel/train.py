"""Training step: the rectified-flow (v_lerp) objective for NaDiT over a
mesh.

Port of seedvr2_tpu.parallel.train. Training goes through this API only,
as in the JAX package:

    init_state, train_step = make_train_step(cfg, plan, mesh, lr, T)
    state = init_state(model)
    state, loss = train_step(state, batch, generator)

The loss (`flow_loss`) is JAX's: x_t = LerpSchedule(T).forward(x0, noise,
t) with t = sigmoid(N(0, 1)) * T (core.diffusion.logitnormal_timesteps),
the target noise - x0, the mean square of the prediction's error in fp32;
x_t, the condition and the text enter the DiT in the compute dtype (bf16 by
default). Both window plans train: the grouped one through kernels K1 and
K2, the uniform one (`build_dit_plan(..., uniform=True)`) through kernel
K9, each forward and its hand-written backward through their autograd
Functions. `attention_mode` is the serving runner's: "flash" (K1 / K9),
or "xla", JAX's set_attention_mode("xla"): the SDPA lane
(ops/attention.py), which autograd carries, and K2 with its backward on
the grouped plan still. A quantised tree (K3-K7) is refused.

Parallelism, one process a device (parallel/mesh.py), the compute
following the sharding:
 - the parameters, AdamW's two moments and the gradients live as fp32
   pieces under `train_sharding`: tp cuts each block projection as the
   serving slices do (parallel/tp.py), fsdp the dim tp leaves whole. A
   rank holds 1/(fsdp*tp) of every tensor cut both ways;
 - a rank computes on its local NaDiT (tp.local_training_dit: its heads
   and hidden columns) with the tp line's collectives under autograd
   (comm.TPComm): an fp32 sum after each row-sharded projection, a sum of
   the gradient at the input of each column-sharded one;
 - the weights are bound block by block (`_BlockRun`): a block's pieces
   are cast to the compute dtype and, under fsdp, gathered over the fsdp
   line (comm.all_gather_, one collective) and laid out as one bucket
   just before its forward, freed
   after it, and gathered again for its backward only: autograd's saved
   copies of them are packed as handles into the bucket
   (saved_tensors_hooks) and re-gathered on unpack. The parameters outside
   the blocks are gathered once for the step. `train_step.stats`
   (GatherStats) counts the gathered bytes alive by their storage, and
   no step gathers a whole parameter (comm.gather_shards.calls);
 - the rows are JAX's batch_sharding, over dp only: the ranks of an fsdp
   or a tp line compute the same rows. Each rank draws the noise and the
   timesteps of the WHOLE batch from the generator and takes its dp rows,
   so any mesh computes what one rank does; the local loss is the rows'
   sum of squares over the whole batch's count. A block's gradient pieces
   (its fsdp pieces of its tp-local gradients) are summed in fp32 over dp,
   one collective a block, so the batch mean is taken once;
 - each rank updates its own pieces with AdamW (optax.adamw's defaults:
   b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01 on every parameter).
One rank (no mesh) runs the same block-by-block step, so an fsdp mesh at
dp 1 computes its arithmetic bit for bit.

The state's tensors are updated in place, as JAX's donated state is.
Checkpoints (`save_train_state` / `restore_train_state`) are one
safetensors file of the whole parameters, both moments and the step,
written by the mesh's first rank and restored onto any mesh.
"""

import weakref
from collections import Counter
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.configs import DiTConfig
from ..core.diffusion import LerpSchedule, logitnormal_timesteps
from ..core.weights import read_safetensors, write_safetensors
from ..models.dit.nadit import (DevicePlan, DiTPlan, NaDiT, nadit_forward,
                                upload_plan)
from ..ops.attention import resolve_attention_mode
from ..ops.int8_matmul import W8A8Linear
from ..ops.quant_matmul import AffineLinear, Q8Linear
from .comm import (TPComm, agree_max, all_gather_, all_reduce_sum_,
                   gather_shards)
from .mesh import Mesh, batch_sharding, shard, train_sharding
from .tp import local_training_dit, qkv_row_order

# optax.adamw's defaults
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


class TrainLayout:
    """Where each parameter's piece lies on a mesh: its train_sharding spec
    (tp over the dim the rank's tp.local_training_dit cuts) and, for a qkv
    projection under tp, the permutation of its rows by head block
    (tp.qkv_row_order) applied before the cut. The mesh needs no
    process group for `piece` (any rank's coordinates will do)."""

    def __init__(self, cfg: DiTConfig, mesh: Mesh,
                 shapes: Dict[str, Tuple[int, ...]]):
        self.mesh = mesh
        local = {k: tuple(p.shape) for k, p in local_training_dit(
            cfg, mesh, torch.float32).named_parameters()}
        self.specs = {k: train_sharding(mesh, s, local[k])
                      for k, s in shapes.items()}
        tp = mesh.shape.get("tp", 1)
        self.perms = {}
        if tp > 1:
            perm = qkv_row_order(cfg, tp)
            for k in shapes:
                if ".attn.proj_qkv." in k:
                    self.perms[k] = (torch.as_tensor(perm),
                                     torch.as_tensor(np.argsort(perm)))

    def piece(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor `whole` (a view, or a
        permuted copy)."""
        if name in self.perms:
            whole = whole.index_select(0, self.perms[name][0].to(whole.device))
        return shard(self.mesh, whole, self.specs[name])

    def fsdp_piece(self, name: str, local: torch.Tensor,
                   index: Optional[int] = None) -> torch.Tensor:
        """The fsdp piece (a view) of a tp-local tensor that the rank at
        `index` of the fsdp line holds (default this rank)."""
        dim = self.specs[name].index("fsdp")
        if index is None:
            index = self.mesh.coords()["fsdp"]
        size = local.shape[dim] // self.mesh.shape["fsdp"]
        return local.narrow(dim, index * size, size)

    def whole(self, name: str, piece: torch.Tensor,
              shape: Tuple[int, ...]) -> torch.Tensor:
        """The whole tensor of which each rank holds `piece` (collective
        over the lines of its spec's axes)."""
        full = gather_shards(piece, self.specs[name], shape, self.mesh)
        if name in self.perms:
            full = full.index_select(0, self.perms[name][1].to(full.device))
        return full


class TrainState(NamedTuple):
    """params: this rank's fp32 piece of every parameter, by state-dict
    name; opt_state: {"mu": ..., "nu": ...}, AdamW's moments, pieces like
    params; step: the steps taken (optax's count). mesh, shapes (each
    parameter's whole shape) and layout (TrainLayout) say how the pieces
    lie; None for a state of whole tensors on one rank."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Dict[str, torch.Tensor]]
    step: int
    mesh: Optional[Mesh] = None
    shapes: Optional[Dict[str, Tuple[int, ...]]] = None
    layout: Optional[TrainLayout] = None


class GatherStats:
    """The compute weights a train step gathers, counted by memory: `alive`
    the bytes of gathered buckets and of the collectives' buffers whose
    storage is still allocated (a finalizer on each storage takes it off
    when the allocator gets it back, whoever held it), `high_water` their
    most at once since `reset`, `gathers` the gathers by bucket ("outer",
    or a block's index)."""

    def __init__(self):
        self.alive = 0
        self.reset()

    def reset(self) -> None:
        self.high_water = self.alive
        self.gathers = Counter()

    def track(self, buf: torch.Tensor, key=None) -> None:
        """Count `buf`'s bytes while its storage lives; with a `key`, as
        that bucket's gather."""
        n = buf.numel() * buf.element_size()
        self.alive += n
        self.high_water = max(self.high_water, self.alive)
        if key is not None:
            self.gathers[key] += 1
        weakref.finalize(buf.untyped_storage(), self._freed, n)

    def _freed(self, n: int) -> None:
        self.alive -= n


def check_trainable(model: NaDiT) -> None:
    """Raise on what the training path does not take: a quantised tree (the
    serving lanes K3-K7: no trainable weights) or weights neither bf16 nor
    fp32."""
    for name, mod in model.named_modules():
        if isinstance(mod, (W8A8Linear, Q8Linear, AffineLinear)):
            raise ValueError(f"{name} is a quantised serving linear "
                             f"({type(mod).__name__}); only bf16 / fp32 "
                             "trees train")
    for name, p in model.named_parameters():
        if p.dtype not in COMPUTE_DTYPES:
            raise ValueError(f"{name} is {p.dtype}; only bf16 / fp32 "
                             "weights train")


def unreached_by_design(cfg: DiTConfig, name: str) -> bool:
    """Whether the loss may reach parameter `name` through no path: a
    text-branch parameter of the last block. The text stream is discarded
    after that block (the DiT's output is the video tokens), so whatever
    only its text output feeds (the 3B's proj_out.txt in a block with its
    own text weights; the 7B's too, and its txt mlp and out gates) gets no
    gradient, where JAX's is zero."""
    return (name.startswith(f"blocks.{cfg.num_layers - 1}.")
            and ".txt." in name)


def _sq_sum(model: NaDiT, batch: Dict[str, torch.Tensor],
            noise: torch.Tensor, t: torch.Tensor, dplan: DevicePlan, dtype,
            T: float, use_kernels: bool = True, attention_mode="flash",
            tp: Optional[TPComm] = None,
            run_block: Optional[Callable] = None) -> torch.Tensor:
    """The fp32 sum of squares of the prediction's error over the rows."""
    x0 = batch["latent"].float()
    t = t.float()
    x_t = LerpSchedule(T).forward(x0, noise.float(), t[:, None, None, None,
                                                        None])
    target = noise.float() - x0  # v_lerp
    vid_in = torch.cat([x_t.to(dtype), batch["cond"].to(dtype)], dim=-1)
    pred = nadit_forward(model, vid_in, batch["txt"].to(dtype), t, dplan,
                         use_kernels=use_kernels,
                         attention_mode=attention_mode, tp=tp,
                         run_block=run_block)
    err = pred.float() - target
    return (err * err).sum()


def flow_loss(model: NaDiT, batch: Dict[str, torch.Tensor],
              noise: torch.Tensor, t: torch.Tensor,
              plan: Union[DiTPlan, DevicePlan], dtype=torch.bfloat16,
              T: float = 1000.0, use_kernels: bool = True,
              attention_mode: str = "flash") -> torch.Tensor:
    """JAX's loss_fn with the draws passed in: the fp32 mean square of
    nadit_forward(x_t | cond, txt, t) - (noise - x0) over every element.

    batch: latent (B, T, h, w, vid_out_channels) clean latents, cond (B, T,
    h, w, vid_in - vid_out) the condition channels, txt (B, L, txt_in_dim);
    noise: like latent, fp32; t: (B,) timesteps. plan: the grouped or the
    uniform window plan (a DiTPlan is uploaded to the latent's device).
    dtype: the compute dtype of the DiT's inputs (bf16, or fp32 for an
    exact comparison). use_kernels: False runs the kernels' plain versions
    (K1's and K2's, or K9's) and autograd through them (nadit_forward's
    switch), the reference the kernels' gradients are held against.
    attention_mode: "flash" or "xla" (or an alias), nadit_forward's."""
    if not isinstance(plan, DevicePlan):
        plan = upload_plan(plan, model.cfg, batch["latent"].device)
    check_trainable(model)
    return _sq_sum(model, batch, noise, t, plan, dtype, T, use_kernels,
                   attention_mode) / batch["latent"].numel()


def adamw_(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
           g: torch.Tensor, count: int, lr: float) -> None:
    """One optax.adamw update of p in place (fp32): the moments' EMAs, their
    bias corrections at `count` (the step after this one's increment),
    mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p, times -lr."""
    mu.mul_(B1).add_(g, alpha=1.0 - B1)
    nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
    bc1 = float(1.0 - np.float32(B1) ** np.float32(count))
    bc2 = float(1.0 - np.float32(B2) ** np.float32(count))
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
    u.add_(p, alpha=WEIGHT_DECAY)
    p.add_(u, alpha=-lr)


def whole(state: TrainState, tree: Dict[str, torch.Tensor], name: str,
          dtype=torch.float32) -> torch.Tensor:
    """The whole tensor of the piece tree[name] (a parameter or a moment),
    in `dtype`, on every rank of its lines."""
    local = tree[name].to(dtype)
    if state.mesh is None:
        return local
    return state.layout.whole(name, local, state.shapes[name])


def full_params(state: TrainState, dtype=torch.float32
                ) -> Dict[str, torch.Tensor]:
    """Every parameter put back together, by state-dict name."""
    return {k: whole(state, state.params, k, dtype) for k in state.params}


class _Bucket(NamedTuple):
    """The parameters gathered together ("outer": those outside the blocks,
    or one block's): name, offset and tp-local shape of each in one flat
    buffer of `size` elements."""

    key: object
    names: Tuple[str, ...]
    offsets: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    size: int


def _bucket(key, named: List[Tuple[str, Tuple[int, ...]]]) -> _Bucket:
    offsets, off = [], 0
    for _, shape in named:
        offsets.append(off)
        off += int(np.prod(shape))
    return _Bucket(key, tuple(n for n, _ in named), tuple(offsets),
                   tuple(tuple(s) for _, s in named), off)


def _bind(root: nn.Module, tensors: Dict[str, Optional[torch.Tensor]]):
    """Put `tensors` in as the parameters of those names (the modules read
    them as they would their own)."""
    for name, t in tensors.items():
        path, _, attr = name.rpartition(".")
        root.get_submodule(path)._parameters[attr] = t


class _Weight(torch.autograd.Function):
    """A block's compute weight, a view of its gathered bucket, as the
    output of a node that holds no tensor: the block's graph reaches the
    bucket only through what autograd saves (packed as handles), and the
    weight's gradient goes to the block's run instead of a .grad."""

    @staticmethod
    def forward(ctx, anchor, value, sink, name):
        ctx.sink, ctx.name = sink, name
        return value.view_as(value)

    @staticmethod
    def backward(ctx, grad):
        ctx.sink[ctx.name] = grad
        return None, None, None, None


class _BlockStep(torch.autograd.Function):
    """One block of the trainer's forward, its graph held apart: the
    forward runs the block with grad on detached copies of its inputs
    (run.forward), the backward runs that graph back (run.backward) and
    returns the inputs' gradients; the block's weight gradients go to the
    run."""

    @staticmethod
    def forward(ctx, run, x, xt, emb_attn, emb_mlp):
        ctx.set_materialize_grads(False)
        with torch.enable_grad():
            inputs = tuple(t.detach().requires_grad_(t.requires_grad)
                           for t in (x, xt, emb_attn, emb_mlp))
            outs = run.forward(inputs)
        ctx.run, ctx.inputs, ctx.outs = run, inputs, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        got = ctx.run.backward(ctx.inputs, ctx.outs, grads)
        del ctx.inputs, ctx.outs
        return (None, *got)


class _BlockRun:
    """Block i's weights and gradients in one step: `forward` gathers the
    bucket, binds views of it as the block's weights (_Weight), runs the
    block with autograd's saved views of the bucket packed as (offset,
    size, stride) handles, and lets the bucket go; `backward` runs the
    block's graph back, gathering the bucket again at the first handle it
    unpacks and letting it go when done, and hands the weight gradients to
    the step (`take`)."""

    def __init__(self, step, bucket: _Bucket, block: nn.Module, fn):
        self.step, self.bucket, self.block, self.fn = step, bucket, block, fn
        self.grads: Dict[str, torch.Tensor] = {}
        self.ptr = None
        self.again = None

    def pack(self, t: torch.Tensor):
        if t.untyped_storage().data_ptr() == self.ptr:
            return (t.storage_offset(), tuple(t.shape), t.stride())
        return t

    def unpack(self, packed):
        if not isinstance(packed, tuple):
            return packed
        if self.again is None:
            self.again = self.step.gather(self.bucket)
        offset, size, stride = packed
        return self.again.as_strided(size, stride, offset)

    def forward(self, inputs):
        buf = self.step.gather(self.bucket)
        self.ptr = buf.untyped_storage().data_ptr()
        self.anchor = torch.zeros((), device=buf.device, requires_grad=True)
        prefix = f"blocks.{self.bucket.key}."
        weights = {
            name[len(prefix):]: _Weight.apply(
                self.anchor, buf[off:off + int(np.prod(shape))].view(shape),
                self.grads, name)
            for name, off, shape in zip(self.bucket.names,
                                        self.bucket.offsets,
                                        self.bucket.shapes)}
        _bind(self.block, weights)
        try:
            with torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                          self.unpack):
                return self.fn(*inputs)
        finally:
            _bind(self.block, {k: None for k in weights})
            self.ptr = None

    def backward(self, inputs, outs, grads):
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        need = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], need + [self.anchor],
            [g for _, g in pairs], allow_unused=True)) if pairs else None
        self.again = None
        self.step.take(self.bucket, self.grads)
        self.grads = {}
        return tuple(next(got) if got is not None and t.requires_grad
                     else None for t in inputs)


class _Step:
    """The gathers and gradient pieces of one train step on one rank."""

    def __init__(self, state: TrainState, dtype, device, cfg: DiTConfig,
                 stats: GatherStats):
        self.state, self.dtype, self.device = state, dtype, device
        self.cfg, self.stats = cfg, stats
        mesh = state.mesh
        self.fsdp = 1 if mesh is None else mesh.shape.get("fsdp", 1)
        self.grads: Dict[str, torch.Tensor] = {}
        self.missing: List[str] = []

    def gather(self, bucket: _Bucket) -> torch.Tensor:
        """The bucket's tp-local weights in the compute dtype, whole over
        fsdp: the fsdp pieces of every rank of the fsdp line gathered in
        one collective (each rank's, cast, in its row of one buffer), then
        laid out whole in the bucket beside the tensors fsdp leaves
        whole, which every rank holds."""
        params, layout = self.state.params, self.state.layout
        cut, width = {}, 0  # a piece's offset in a row; a row's length
        for name in bucket.names:
            if layout is not None and "fsdp" in layout.specs[name]:
                cut[name] = width
                width += params[name].numel()
        if cut:
            rows = torch.empty((self.fsdp, width), dtype=self.dtype,
                               device=self.device)
            self.stats.track(rows)
            mine = rows[self.state.mesh.coords()["fsdp"]]
            for name, at in cut.items():
                p = params[name]
                mine[at:at + p.numel()].view(p.shape).copy_(p)
            all_gather_(rows, self.state.mesh, "fsdp")
        buf = torch.empty(bucket.size, dtype=self.dtype, device=self.device)
        self.stats.track(buf, bucket.key)
        for name, off, shape in zip(bucket.names, bucket.offsets,
                                    bucket.shapes):
            view = buf[off:off + int(np.prod(shape))].view(shape)
            p = params[name]
            if name not in cut:
                view.copy_(p)
                continue
            at = cut[name]
            for i in range(self.fsdp):
                layout.fsdp_piece(name, view, i).copy_(
                    rows[i, at:at + p.numel()].view(p.shape))
        return buf

    def take(self, bucket: _Bucket, grads: Dict[str, torch.Tensor]) -> None:
        """The bucket's gradients (tp-local, the compute dtype) as this
        rank's fp32 pieces, summed over dp in one collective. A missing
        gradient is zeros, and recorded unless the loss reaches that
        parameter through no path by design."""
        layout = self.state.layout
        shapes = [self.state.params[n].shape for n in bucket.names]
        flat = torch.empty(sum(int(np.prod(s)) for s in shapes),
                           dtype=torch.float32, device=self.device)
        views, off = {}, 0
        for name, shape in zip(bucket.names, shapes):
            n = int(np.prod(shape))
            views[name] = out = flat[off:off + n].view(shape)
            off += n
            g = grads.get(name)
            if g is None:
                out.zero_()
                if not unreached_by_design(self.cfg, name):
                    self.missing.append(name)
            elif layout is not None and "fsdp" in layout.specs[name]:
                out.copy_(layout.fsdp_piece(name, g))
            else:
                out.copy_(g)
        all_reduce_sum_(flat, self.state.mesh, "dp")
        self.grads.update(views)


def make_train_step(cfg: DiTConfig, plan: Union[DiTPlan, DevicePlan],
                    mesh: Optional[Mesh] = None,
                    learning_rate: float = 1e-4, T: float = 1000.0,
                    device="cuda", dtype=torch.bfloat16,
                    use_kernels: bool = True,
                    attention_mode: str = "flash"):
    """(init_state, train_step) of flow-matching training of `cfg`'s NaDiT
    on the window plan `plan` (grouped, or uniform: build_dit_plan(...,
    uniform=True)), over `mesh` (None: one rank), on
    `device` (the card unless the caller asks for the CPU). dtype: the
    compute dtype (bf16; fp32 runs the same step exactly, on the CPU).
    use_kernels: as flow_loss's (False: the plain reference).
    attention_mode: "flash" (K1 / K9) or "xla" (the SDPA lane), or an
    alias, as the serving runner takes it.

    init_state(model or TrainState): this rank's fp32 pieces of a NaDiT's
    parameters with zero moments at step 0, or of a one-rank state of whole
    tensors (train_state_from_jax's) with its moments and step.

    train_step(state, batch, generator=None, *, noise=None, t=None) ->
    (state, loss): one AdamW step on the batch (flow_loss's keys, the whole
    batch on every rank). The noise (the latent's shape) and the timesteps
    (B,) are drawn from `generator` (noise first), or given. loss: the
    batch's fp32 mean square, a 0-d tensor, the same on every rank.
    train_step.gradients(state, batch, generator=None, *, noise=None,
    t=None) -> (loss, {name: this rank's fp32 gradient piece}) takes the
    same step's gradients without the update; train_step.stats is the
    steps' GatherStats."""
    device = torch.device(device)
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype}: bf16 or fp32")
    mode = resolve_attention_mode(attention_mode)
    dplan = plan if isinstance(plan, DevicePlan) else upload_plan(plan, cfg,
                                                                  device)
    if mesh is not None and mesh.size == 1:
        mesh = None
    skeleton = local_training_dit(cfg, mesh, dtype)
    tp = TPComm(mesh) if mesh is not None and mesh.shape.get("tp", 1) > 1 \
        else None
    with torch.device("meta"):
        shapes = {k: tuple(p.shape) for k, p in
                  NaDiT(cfg, dtype=torch.float32).named_parameters()}
    local = {k: tuple(p.shape) for k, p in skeleton.named_parameters()}
    layout = None if mesh is None else TrainLayout(cfg, mesh, shapes)
    blocks = [_bucket(i, [(k, s) for k, s in local.items()
                          if k.startswith(f"blocks.{i}.")])
              for i in range(cfg.num_layers)]
    outer = _bucket("outer", [(k, s) for k, s in local.items()
                              if not k.startswith("blocks.")])
    stats = GatherStats()

    def pieces(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's fp32 pieces of {name: whole tensor}, fresh copies on
        `device`."""
        out = {}
        for k, v in tree.items():
            v = v.detach().to(device=device, dtype=torch.float32)
            if layout is not None:
                v = layout.piece(k, v)
            out[k] = v.clone(memory_format=torch.contiguous_format)
        return out

    def init_state(model) -> TrainState:
        if isinstance(model, TrainState):
            if model.mesh is not None:
                raise ValueError("the state is laid out over a mesh "
                                 "already; train_step takes it as it is")
            src, step = model.params, model.step
            moments = {k: pieces(model.opt_state[k]) for k in ("mu", "nu")}
        else:
            check_trainable(model)
            src, step = dict(model.named_parameters()), 0
            moments = None
        if set(src) != set(shapes):
            raise ValueError("the parameters are not cfg's NaDiT's: "
                             f"{sorted(set(src) ^ set(shapes))[:4]}")
        params = pieces({k: src[k] for k in shapes})
        if moments is None:
            moments = {k: {n: torch.zeros_like(v) for n, v in params.items()}
                       for k in ("mu", "nu")}
        return TrainState(params, moments, int(step), mesh,
                          shapes if mesh is not None else None, layout)

    def rows(x: torch.Tensor) -> torch.Tensor:
        """This rank's dp rows of a whole-batch tensor."""
        x = x.to(device)
        if mesh is None:
            return x
        return shard(mesh, x, batch_sharding(mesh, x.dim()))

    def gradients(state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None,
                  t: Optional[torch.Tensor] = None):
        latent = batch["latent"]
        b = latent.shape[0]
        if noise is None or t is None:
            if generator is None:
                raise ValueError("train_step needs a generator, or both the "
                                 "noise and the timesteps")
            gdev = generator.device
            noise = torch.randn(tuple(latent.shape), generator=generator,
                                dtype=torch.float32, device=gdev)
            t = logitnormal_timesteps(generator, (b,), T)
        local_rows = {k: rows(v) for k, v in batch.items()}
        run = _Step(state, dtype, device, cfg, stats)

        def run_block(i, fn, *xs):
            return _BlockStep.apply(
                _BlockRun(run, blocks[i], skeleton.blocks[i], fn), *xs)

        buf = run.gather(outer)
        leaves = {name: buf[off:off + int(np.prod(shape))].view(shape)
                  .detach().requires_grad_()
                  for name, off, shape in zip(outer.names, outer.offsets,
                                              outer.shapes)}
        _bind(skeleton, leaves)
        try:
            loss = _sq_sum(skeleton, local_rows, rows(noise), rows(t), dplan,
                           dtype, T, use_kernels, mode, tp, run_block) \
                / latent.numel()
            loss.backward()
        finally:
            _bind(skeleton, {k: None for k in leaves})
        run.take(outer, {k: v.grad for k, v in leaves.items()})
        del leaves, buf
        loss = all_reduce_sum_(loss.detach().clone(), mesh, "dp")
        if run.missing:
            # any other missing gradient is a cut autograd graph (a kernel
            # output without its Function), which would leave AdamW's
            # weight decay alone
            raise RuntimeError(f"no gradient for {len(run.missing)} "
                               f"parameters after backward: "
                               f"{run.missing[:4]}")
        return loss, run.grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        loss, grads = gradients(state, batch, generator, noise=noise, t=t)
        step = state.step + 1
        for name, g in grads.items():
            adamw_(state.params[name], state.opt_state["mu"][name],
                   state.opt_state["nu"][name], g, step, learning_rate)
        return state._replace(step=step), loss

    train_step.gradients = gradients
    train_step.stats = stats
    return init_state, train_step


def _tensor_names(state: TrainState):
    for name in state.params:
        yield f"params/{name}", state.params, name
        for k in ("mu", "nu"):
            yield f"{k}/{name}", state.opt_state[k], name


def save_train_state(state: TrainState, path: str) -> None:
    """One safetensors file of the whole parameters ("params/<name>"), both
    moments ("mu/<name>", "nu/<name>"), fp32, and the step ("step", int64):
    every rank of the state's mesh takes part (the pieces are gathered),
    the mesh's first rank writes, and no rank returns before the file is
    whole."""
    mesh = state.mesh
    tensors = {key: whole(state, tree, name)
               for key, tree, name in _tensor_names(state)}
    tensors["step"] = torch.tensor(state.step, dtype=torch.int64)
    if mesh is None or mesh.rank == mesh.ranks[0]:
        write_safetensors(path, tensors)
    if mesh is not None:
        del tensors
        agree_max([0], mesh, next(iter(state.params.values())).device)


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """The state saved at `path` laid out as `template` is (its mesh, its
    devices): every rank reads the file and keeps its pieces, on any
    mesh."""
    saved = read_safetensors(path)
    layout = template.layout
    device = next(iter(template.params.values())).device

    def pieces(prefix):
        out = {}
        for n in template.params:
            t = saved[f"{prefix}/{n}"]
            if layout is not None:
                t = layout.piece(n, t)
            out[n] = t.to(device=device, dtype=torch.float32).contiguous()
        return out

    params = pieces("params")
    moments = {k: pieces(k) for k in ("mu", "nu")}
    return template._replace(params=params, opt_state=moments,
                             step=int(saved["step"]))
