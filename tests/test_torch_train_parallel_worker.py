"""One rank of tests/test_torch_train_parallel.py's 4-rank gloo world.

Run by that file in a subprocess (RANK / WORLD_SIZE / MASTER_* in the
environment, SPEC naming its spec.json); it defines no tests and imports
neither JAX nor the JAX package. Every rank makes every mesh, in one order
(the 2-rank mesh twice: over ranks 0-1 and over ranks 2-3), trains on each
the tiny DiT of the spec for three fp32 steps beside the same steps on one
rank (no mesh) in this process, on the grouped and on the uniform window
plan, and writes {check: {"ok", "detail"}} to rank<N>.json.
"""

import json
import os
import re
import sys

import numpy as np
import torch
import torch.distributed as dist

from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.weights import read_safetensors
from seedvr2_tpu_torch.models.dit import nadit
from seedvr2_tpu_torch.parallel import comm, train
from seedvr2_tpu_torch.parallel.mesh import Mesh, make_mesh
from seedvr2_tpu_torch.parallel.tp import local_training_dit

STEPS = 3
# fp32 on every mesh against one rank: the gradients' dp sum and the tp
# sums of the partial products and of the gradients run in another order
# than one rank's whole-batch, all-heads backward (fsdp alone at dp 1
# computes one rank's arithmetic exactly, checked bit-equal)
TOL = 1e-6
# the dims tensor parallelism cuts, by state-dict name, as the serving
# slices cut them: the rows (dim 0) of the column-sharded projections (qkv,
# the mlp's proj_in and gate, with their biases), the columns (dim 1) of the
# row-sharded ones (the attention's and the mlp's proj_out; their biases
# whole, added after the sum)
TP_CUTS = ((re.compile(r"blocks\.\d+\.(attn\.proj_qkv\.\w+|mlp\.\w+\."
                       r"proj_in(_gate)?)\.(weight|bias)"), 0),
           (re.compile(r"blocks\.\d+\.(attn\.proj_out\.\w+|mlp\.\w+\."
                       r"proj_out)\.weight"), 1))
# the (dp, fsdp, tp) meshes, each against one rank on both plans
MESHES = (("dp2_fsdp2", (2, 2, 1)), ("fsdp4", (1, 4, 1)),
          ("fsdp2_tp2", (1, 2, 2)), ("tp2", (1, 1, 2)),
          ("dp2_tp2", (2, 1, 2)))


def _rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def pair_mesh(shape):
    """A 2-rank mesh of `shape` over ranks 0-1 or 2-3, whichever holds this
    rank (both groups made on every rank, in one order)."""
    rank = dist.get_rank()
    groups = {r: dist.new_group(list(r)) for r in ((0, 1), (2, 3))}
    mine = (0, 1) if rank < 2 else (2, 3)
    return Mesh(("dp", "fsdp", "tp"), dict(zip(("dp", "fsdp", "tp"), shape)),
                mine, rank, {mine: groups[mine]})


def check_mesh(w, name, mesh, ref, uniform=False):
    """Three steps on `mesh` against one rank's (`ref`: state, losses and
    the first step's whole gradients), on the grouped or the uniform plan:
    losses and whole parameters within TOL, each rank's gradient piece of
    the first step against its piece of one rank's whole gradient within
    TOL, and each rank holding 1 / (fsdp * tp) of every tensor
    train_sharding cuts both ways (its parameters and both moments)."""
    ref_state, ref_losses, ref_grads = ref
    init_state, step = w.make(mesh, uniform)
    state = init_state(w.model)
    _, grads = step.gradients(state, w.batch, w.generator(0))
    g_err = max(_rel(grads[k], state.layout.piece(k, ref_grads[k]))
                for k in grads)
    state, losses = w.steps(state, step)
    whole = train.full_params(state)
    loss_err = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(losses, ref_losses))
    p_err = max(_rel(whole[k], ref_state.params[k]) for k in whole)
    pieces_ok, cut = True, 0
    for k, piece in state.params.items():
        spec = state.layout.specs[k]
        ways = int(np.prod([mesh.shape[a] for a in spec if a is not None]))
        cut += ways == mesh.shape["fsdp"] * mesh.shape["tp"] > 1
        full = int(np.prod(state.shapes[k]))
        for t in (piece, state.opt_state["mu"][k], state.opt_state["nu"][k]):
            pieces_ok &= t.numel() * ways == full
    plan = "uniform_" if uniform else ""
    w.record(f"train_{plan}{name}",
             loss_err <= TOL and p_err <= TOL and g_err <= TOL
             and pieces_ok and cut > 0 and state.step == STEPS,
             f"loss rel {loss_err:.3g}, params rel {p_err:.3g}, gradient "
             f"pieces rel {g_err:.3g} (tol {TOL}); {cut} tensors cut "
             f"1/(fsdp*tp), pieces sized {pieces_ok}")
    return state, losses


class World:
    def __init__(self, spec):
        self.spec = spec
        self.rank = dist.get_rank()
        self.results = {}
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in spec["cfg"].items()}
        self.cfg = tc.DiTConfig(**kw)
        self.plans = {u: nadit.build_dit_plan(self.cfg, tuple(spec["shape"]),
                                              spec["txt_len"], uniform=u)
                      for u in (False, True)}
        data = np.load(os.path.join(spec["out"], "inputs.npz"))
        self.batch = {k: torch.from_numpy(data[k])
                      for k in ("latent", "cond", "txt")}
        self.model = nadit.NaDiT(self.cfg, dtype=torch.float32)
        self.model.load_state_dict(read_safetensors(
            os.path.join(spec["out"], "dit.safetensors")), strict=True)

    def record(self, name, ok, detail=""):
        self.results[name] = {"ok": bool(ok), "detail": str(detail)}

    def make(self, mesh, uniform=False):
        return train.make_train_step(self.cfg, self.plans[uniform], mesh,
                                     device="cpu", dtype=torch.float32)

    @staticmethod
    def generator(i):
        return torch.Generator().manual_seed(1000 + i)

    def steps(self, state, step, steps=range(STEPS)):
        """Steps `steps` (each drawing from its own seeded generator) from
        `state`: (state, losses)."""
        losses = []
        for i in steps:
            state, loss = step(state, self.batch, self.generator(i))
            losses.append(loss)
        return state, losses

    def reference(self, uniform):
        """One rank's three steps and first gradients on a plan."""
        init_state, step = self.make(None, uniform)
        state = init_state(self.model)
        _, grads = step.gradients(state, self.batch, self.generator(0))
        state, losses = self.steps(state, step)
        return state, losses, grads


def check_bit_equal(w, name, mesh, refs):
    """An fsdp mesh at dp 1 computes one rank's arithmetic on weights
    gathered bit for bit: three steps on each plan bit-equal to one
    rank's, losses and whole parameters."""
    details, ok = [], True
    for uniform in (False, True):
        init_state, step = w.make(mesh, uniform)
        state, losses = w.steps(init_state(w.model), step)
        ref_state, ref_losses, _ = refs[uniform]
        whole = train.full_params(state)
        same = [torch.equal(whole[k], ref_state.params[k]) for k in whole]
        eq = all(torch.equal(a, b) for a, b in zip(losses, ref_losses))
        ok &= all(same) and eq
        details.append(f"{'uniform' if uniform else 'grouped'}: "
                       f"{sum(same)}/{len(same)} tensors bit-equal, losses "
                       f"equal {eq}")
    w.record(f"bit_equal_{name}", ok, "; ".join(details))


def check_gathers(w, name, mesh):
    """Under fsdp the weights are gathered block by block: over three steps
    each block's bucket twice a step (its forward, its backward) and the
    parameters outside the blocks once, the gathered bytes alive at once
    (by their storage) never more than two blocks' and the outer bucket,
    none alive after a step, and no whole parameter gathered
    (comm.gather_shards) in any step."""
    init_state, step = w.make(mesh)
    state = init_state(w.model)
    local = dict(local_training_dit(w.cfg, mesh, torch.float32)
                 .named_parameters())
    size = {}
    for k, p in local.items():
        key = int(k.split(".")[1]) if k.startswith("blocks.") else "outer"
        size[key] = size.get(key, 0) + p.numel() * 4
    blocks = [v for k, v in size.items() if k != "outer"]
    bound = size["outer"] + 2 * max(blocks)
    step.stats.reset()
    whole_before = comm.gather_shards.calls
    state, _ = w.steps(state, step)
    whole_calls = comm.gather_shards.calls - whole_before
    gathers = dict(step.stats.gathers)
    want = {k: (STEPS if k == "outer" else 2 * STEPS) for k in size}
    hw, alive = step.stats.high_water, step.stats.alive
    w.record(f"gathers_{name}",
             hw <= bound and alive == 0 and gathers == want
             and whole_calls == 0,
             f"high water {hw} bytes (outer {size['outer']} + two blocks "
             f"{2 * max(blocks)} = {bound}; one block + outer "
             f"{size['outer'] + max(blocks)}), {alive} alive after; gathers "
             f"{gathers} (want {want}); whole-parameter gathers in the steps "
             f"{whole_calls}")


def tp_cut(name: str):
    """The dim TP_CUTS cuts of parameter `name`, or None."""
    for pattern, dim in TP_CUTS:
        if pattern.fullmatch(name):
            return dim
    return None


def check_local_shapes(w, name, mesh):
    """Under tp a rank's local NaDiT holds each weight TP_CUTS names at its
    tp piece's shape (the trainer's pieces at fsdp 1), and every other one
    whole; the trainer's layout cuts over tp exactly those dims."""
    init_state, _ = w.make(mesh)
    state = init_state(w.model)
    local = dict(local_training_dit(w.cfg, mesh, torch.float32)
                 .named_parameters())
    tp = mesh.shape["tp"]
    cut = [k for k in local if tp_cut(k) is not None]
    want = {k: tuple(n // tp if d == tp_cut(k) else n
                     for d, n in enumerate(state.shapes[k])) for k in local}
    bad = [k for k, p in local.items() if tuple(p.shape) != want[k]]
    if mesh.shape["fsdp"] == 1:
        bad += [k for k, p in local.items()
                if tuple(p.shape) != tuple(state.params[k].shape)]
    bad += [k for k, spec in state.layout.specs.items()
            if [d for d, a in enumerate(spec) if a == "tp"]
            != ([] if tp_cut(k) is None else [tp_cut(k)])]
    w.record(f"local_shapes_{name}", not bad and len(cut) > 0,
             f"{len(cut)} weights cut over tp {tp}; shapes or tp specs "
             f"unlike the tp pieces: {bad[:4]}")


def check_checkpoint(w, mesh, path):
    """Two steps on the 4-rank mesh, saved, a third step there. Restored
    onto the mesh, the third step is bit-equal to the run that never
    stopped; restored on one rank (rank 0), the parameters are the saved
    ones bit for bit and its third step lies within TOL of the mesh's (tp
    sums in another order)."""
    init_state, step = w.make(mesh)
    state, _ = w.steps(init_state(w.model), step, steps=range(2))
    saved = {k: v.clone() for k, v in train.full_params(state).items()}
    train.save_train_state(state, path)
    state, (loss,) = w.steps(state, step, steps=range(2, 3))
    whole = train.full_params(state)
    back = train.restore_train_state(path, state)
    back, (loss_b,) = w.steps(back, step, steps=range(2, 3))
    same = all(torch.equal(back.params[k], state.params[k])
               for k in state.params) and torch.equal(loss, loss_b)
    ok, detail = same, f"restored onto the mesh: step 3 bit-equal {same}"
    if w.rank == 0:
        init1, step1 = w.make(None)
        one = train.restore_train_state(path, init1(w.model))
        exact = all(torch.equal(one.params[k], saved[k]) for k in saved)
        one, (loss1,) = w.steps(one, step1, steps=range(2, 3))
        p_err = max(_rel(one.params[k], whole[k]) for k in whole)
        l_err = abs(float(loss1) - float(loss)) / abs(float(loss))
        ok &= exact and p_err <= TOL and l_err <= TOL and one.step == 3
        detail += (f"; on one rank: saved parameters bit-equal {exact}, "
                   f"step 3 params rel {p_err:.3g}, loss rel {l_err:.3g} "
                   f"(tol {TOL})")
    w.record("checkpoint_4_ranks_to_1", ok, detail)


def main():
    spec = json.load(open(os.environ["SPEC"]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    w = World(spec)
    meshes = {name: (pair_mesh(shape) if int(np.prod(shape)) == 2
                     else make_mesh(4, ("dp", "fsdp", "tp"), shape))
              for name, shape in MESHES}
    refs = {u: w.reference(u) for u in (False, True)}
    for uniform in (False, True):
        for name, mesh in meshes.items():
            check_mesh(w, name, mesh, refs[uniform], uniform)
    check_bit_equal(w, "fsdp4", meshes["fsdp4"], refs)
    check_gathers(w, "fsdp4", meshes["fsdp4"])
    check_gathers(w, "fsdp2_tp2", meshes["fsdp2_tp2"])
    check_local_shapes(w, "tp2", meshes["tp2"])
    check_local_shapes(w, "fsdp2_tp2", meshes["fsdp2_tp2"])
    check_checkpoint(w, meshes["fsdp2_tp2"],
                     os.path.join(spec["out"], "state.safetensors"))
    assert not any(m == "seedvr2_tpu" or m.startswith("seedvr2_tpu.")
                   for m in sys.modules)
    with open(os.path.join(spec["out"], f"rank{w.rank}.json"), "w") as f:
        json.dump(w.results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
