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
Functions; nothing in the step depends on the plan. A quantised tree
(K3-K7) or the SDPA lane are refused.

Parallelism, one process a device (parallel/mesh.py):
 - the parameters and AdamW's two moments live as fp32 pieces, the
   `param_sharding` of each tensor (fsdp over the JAX in-dim, tp over the
   JAX out-dim): a rank holds 1/(fsdp*tp) of every sharded tensor;
 - each step, every parameter is put back together over its fsdp and tp
   lines in the compute dtype (comm.gather_shards, bit-exact), and the
   rank runs the forward and backward of its dp rows of the batch. tp is a
   storage axis here, as in JAX's param_sharding: the compute runs on
   whole tensors;
 - each rank draws the noise and the timesteps of the WHOLE batch from the
   generator and takes its dp rows, so any mesh computes what one rank
   does; the local loss is the rows' sum of squares over the whole batch's
   count, and the gradients are summed in fp32 over dp, so the batch mean
   is taken once;
 - each rank updates its own pieces with AdamW (optax.adamw's defaults:
   b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01 on every parameter).

The state's tensors are updated in place, as JAX's donated state is.
Checkpoints (`save_train_state` / `restore_train_state`) are one
safetensors file of the whole parameters, both moments and the step,
written by the mesh's first rank and restored onto any mesh.
"""

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.configs import DiTConfig
from ..core.diffusion import LerpSchedule, logitnormal_timesteps
from ..core.weights import read_safetensors, write_safetensors
from ..models.dit.nadit import (DevicePlan, DiTPlan, NaDiT, nadit_forward,
                                upload_plan)
from ..ops.int8_matmul import W8A8Linear
from ..ops.quant_matmul import AffineLinear, Q8Linear
from .comm import agree_max, all_reduce_sum_, gather_shards
from .mesh import Mesh, batch_sharding, param_sharding, shard, shard_params

# optax.adamw's defaults
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


class TrainState(NamedTuple):
    """params: this rank's fp32 piece of every parameter, by state-dict
    name; opt_state: {"mu": ..., "nu": ...}, AdamW's moments, pieces like
    params; step: the steps taken (optax's count). mesh and shapes (each
    parameter's whole shape) say how the pieces lie; None for a state of
    whole tensors on one rank."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Dict[str, torch.Tensor]]
    step: int
    mesh: Optional[Mesh] = None
    shapes: Optional[Dict[str, Tuple[int, ...]]] = None


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
            T: float, use_kernels: bool = True) -> torch.Tensor:
    """The fp32 sum of squares of the prediction's error over the rows."""
    x0 = batch["latent"].float()
    t = t.float()
    x_t = LerpSchedule(T).forward(x0, noise.float(), t[:, None, None, None,
                                                        None])
    target = noise.float() - x0  # v_lerp
    vid_in = torch.cat([x_t.to(dtype), batch["cond"].to(dtype)], dim=-1)
    pred = nadit_forward(model, vid_in, batch["txt"].to(dtype), t, dplan,
                         use_kernels=use_kernels)
    err = pred.float() - target
    return (err * err).sum()


def flow_loss(model: NaDiT, batch: Dict[str, torch.Tensor],
              noise: torch.Tensor, t: torch.Tensor,
              plan: Union[DiTPlan, DevicePlan], dtype=torch.bfloat16,
              T: float = 1000.0, use_kernels: bool = True) -> torch.Tensor:
    """JAX's loss_fn with the draws passed in: the fp32 mean square of
    nadit_forward(x_t | cond, txt, t) - (noise - x0) over every element.

    batch: latent (B, T, h, w, vid_out_channels) clean latents, cond (B, T,
    h, w, vid_in - vid_out) the condition channels, txt (B, L, txt_in_dim);
    noise: like latent, fp32; t: (B,) timesteps. plan: the grouped or the
    uniform window plan (a DiTPlan is uploaded to the latent's device).
    dtype: the compute dtype of the DiT's inputs (bf16, or fp32 for an
    exact comparison). use_kernels: False runs the kernels' plain versions
    (K1's and K2's, or K9's) and autograd through them (nadit_forward's
    switch), the reference the kernels' gradients are held against."""
    if not isinstance(plan, DevicePlan):
        plan = upload_plan(plan, model.cfg, batch["latent"].device)
    check_trainable(model)
    return _sq_sum(model, batch, noise, t, plan, dtype, T, use_kernels) \
        / batch["latent"].numel()


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
    shape = state.shapes[name]
    return gather_shards(local, param_sharding(state.mesh, shape), shape,
                         state.mesh)


def full_params(state: TrainState, dtype=torch.float32
                ) -> Dict[str, torch.Tensor]:
    """Every parameter put back together, by state-dict name."""
    return {k: whole(state, state.params, k, dtype) for k in state.params}


def make_train_step(cfg: DiTConfig, plan: Union[DiTPlan, DevicePlan],
                    mesh: Optional[Mesh] = None,
                    learning_rate: float = 1e-4, T: float = 1000.0,
                    device="cuda", dtype=torch.bfloat16,
                    use_kernels: bool = True):
    """(init_state, train_step) of flow-matching training of `cfg`'s NaDiT
    on the window plan `plan` (grouped, or uniform: build_dit_plan(...,
    uniform=True)), over `mesh` (None: one rank), on
    `device` (the card unless the caller asks for the CPU). dtype: the
    compute dtype (bf16; fp32 runs the same step exactly, on the CPU).
    use_kernels: as flow_loss's (False: the plain reference).

    init_state(model or TrainState): this rank's fp32 pieces of a NaDiT's
    parameters with zero moments at step 0, or of a one-rank state of whole
    tensors (train_state_from_jax's) with its moments and step.

    train_step(state, batch, generator=None, *, noise=None, t=None) ->
    (state, loss): one AdamW step on the batch (flow_loss's keys, the whole
    batch on every rank). The noise (the latent's shape) and the timesteps
    (B,) are drawn from `generator` (noise first), or given. loss: the
    batch's fp32 mean square, a 0-d tensor, the same on every rank."""
    device = torch.device(device)
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype}: bf16 or fp32")
    dplan = plan if isinstance(plan, DevicePlan) else upload_plan(plan, cfg,
                                                                  device)
    if mesh is not None and mesh.size == 1:
        mesh = None
    with torch.device("meta"):
        shapes = {k: tuple(p.shape) for k, p in
                  NaDiT(cfg, dtype=torch.float32).named_parameters()}

    def pieces(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's fp32 pieces of {name: whole tensor}, fresh copies on
        `device`."""
        if mesh is not None:
            tree = shard_params(mesh, tree)
        return {k: v.detach().to(device=device, dtype=torch.float32,
                                 copy=mesh is None).contiguous()
                for k, v in tree.items()}

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
                          shapes if mesh is not None else None)

    def rows(x: torch.Tensor) -> torch.Tensor:
        """This rank's dp rows of a whole-batch tensor."""
        x = x.to(device)
        if mesh is None:
            return x
        return shard(mesh, x, batch_sharding(mesh, x.dim()))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
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
        local = {k: rows(v) for k, v in batch.items()}
        count = latent.numel()
        model = NaDiT(cfg, device="meta", dtype=dtype)
        model.load_state_dict({k: whole(state, state.params, k, dtype)
                               for k in shapes}, strict=True, assign=True)
        loss = _sq_sum(model, local, rows(noise), rows(t), dplan, dtype, T,
                       use_kernels) / count
        loss.backward()
        loss = all_reduce_sum_(loss.detach().clone(), mesh, "dp")
        missing = [k for k, p in model.named_parameters()
                   if p.grad is None and not unreached_by_design(cfg, k)]
        if missing:
            # any other missing gradient is a cut autograd graph (a kernel
            # output without its Function), which would leave AdamW's
            # weight decay alone
            raise RuntimeError(f"no gradient for {len(missing)} parameters "
                               f"after backward: {missing[:4]}")
        step = state.step + 1
        for name, p in model.named_parameters():
            g = (torch.zeros(p.shape, dtype=torch.float32, device=device)
                 if p.grad is None else p.grad.float())
            p.grad = None
            all_reduce_sum_(g, mesh, "dp")
            if mesh is not None:
                g = shard(mesh, g, param_sharding(mesh, g.shape))
            adamw_(state.params[name], state.opt_state["mu"][name],
                   state.opt_state["nu"][name], g, step, learning_rate)
        return state._replace(step=step), loss

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
    mesh = template.mesh
    device = next(iter(template.params.values())).device

    def pieces(prefix):
        tree = {n: saved[f"{prefix}/{n}"] for n in template.params}
        if mesh is not None:
            tree = shard_params(mesh, tree)
        return {n: t.to(device=device, dtype=torch.float32).contiguous()
                for n, t in tree.items()}

    params = pieces("params")
    moments = {k: pieces(k) for k in ("mu", "nu")}
    return TrainState(params, moments, int(saved["step"]), mesh,
                      template.shapes)
