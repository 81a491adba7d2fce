"""One rank of tests/test_torch_train_parallel.py's 4-rank gloo world.

Run by that file in a subprocess (RANK / WORLD_SIZE / MASTER_* in the
environment, SPEC naming its spec.json); it defines no tests and imports
neither JAX nor the JAX package. Every rank makes every mesh, in one order,
trains on each the tiny DiT of the spec for three fp32 steps beside the
same steps on one rank (no mesh) in this process, on the grouped window
plan and, on one mesh, on the uniform one, and writes {check: {"ok",
"detail"}} to rank<N>.json.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.weights import read_safetensors
from seedvr2_tpu_torch.models.dit import nadit
from seedvr2_tpu_torch.parallel import train
from seedvr2_tpu_torch.parallel.mesh import make_mesh, param_sharding

STEPS = 3
# fp32 on every mesh against one rank: the gradients' dp sum runs in
# another order than one rank's whole-batch backward (dp 1 meshes compute
# one rank's arithmetic exactly)
TOL = 1e-6


def _rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


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
        self.plan = self.plans[False]
        data = np.load(os.path.join(spec["out"], "inputs.npz"))
        self.batch = {k: torch.from_numpy(data[k])
                      for k in ("latent", "cond", "txt")}
        self.model = nadit.NaDiT(self.cfg, dtype=torch.float32)
        self.model.load_state_dict(read_safetensors(
            os.path.join(spec["out"], "dit.safetensors")), strict=True)

    def record(self, name, ok, detail=""):
        self.results[name] = {"ok": bool(ok), "detail": str(detail)}

    def run(self, mesh, state=None, steps=range(STEPS), uniform=False):
        """Steps `steps` (each drawing from its own seeded generator) from
        the model, or on from `state` (laid out for `mesh`), on the grouped
        or the uniform window plan: (state, losses)."""
        init_state, step = train.make_train_step(
            self.cfg, self.plans[uniform], mesh, device="cpu",
            dtype=torch.float32)
        if state is None:
            state = init_state(self.model)
        losses = []
        for i in steps:
            g = torch.Generator().manual_seed(1000 + i)
            state, loss = step(state, self.batch, g)
            losses.append(loss)
        return state, losses


def check_mesh(w, name, mesh, ref):
    """Three steps on `mesh` against one rank's (`ref`): losses and whole
    parameters within TOL, and each rank holding 1 / (fsdp * tp) of every
    tensor param_sharding cuts."""
    state, losses = w.run(mesh)
    ref_state, ref_losses = ref
    whole = train.full_params(state)
    loss_err = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(losses, ref_losses))
    p_err = max(_rel(whole[k], ref_state.params[k]) for k in whole)
    pieces_ok, cut = True, 0
    for k, piece in state.params.items():
        spec = param_sharding(mesh, state.shapes[k])
        ways = int(np.prod([mesh.shape[a] for a in spec if a is not None]))
        cut += ways > 1
        full = int(np.prod(state.shapes[k]))
        for t in (piece, state.opt_state["mu"][k], state.opt_state["nu"][k]):
            pieces_ok &= t.numel() * ways == full
    w.record(f"train_{name}",
             loss_err <= TOL and p_err <= TOL and pieces_ok and cut > 0
             and state.step == STEPS,
             f"loss rel {loss_err:.3g}, params rel {p_err:.3g} (tol {TOL}); "
             f"{cut} tensors cut, pieces sized {pieces_ok}")
    return state


def check_uniform(w, name, mesh):
    """Three steps on the uniform window plan on `mesh` (dp 1) against one
    rank's: a dp 1 mesh computes one rank's arithmetic on parameters
    gathered bit for bit, so losses and whole parameters are bit-equal."""
    state, losses = w.run(mesh, uniform=True)
    ref_state, ref_losses = w.run(None, uniform=True)
    whole = train.full_params(state)
    same = [torch.equal(whole[k], ref_state.params[k]) for k in whole]
    w.record(f"train_uniform_{name}",
             all(same) and all(torch.equal(a, b)
                               for a, b in zip(losses, ref_losses))
             and state.step == STEPS,
             f"{sum(same)}/{len(same)} tensors bit-equal, losses "
             f"{[float(x) for x in losses]} vs "
             f"{[float(x) for x in ref_losses]}")


def check_checkpoint(w, mesh, path):
    """Two steps on the 4-rank mesh, saved, a third step there; one rank
    restores the file and takes the third step: bit-equal to the run that
    never stopped (a dp 1 mesh computes one rank's arithmetic)."""
    state, _ = w.run(mesh, steps=range(2))
    train.save_train_state(state, path)
    state, (loss,) = w.run(mesh, state, steps=range(2, 3))
    whole = train.full_params(state)
    ok, detail = True, "not the restoring rank"
    if w.rank == 0:
        init_state, _ = train.make_train_step(w.cfg, w.plan, None,
                                              device="cpu",
                                              dtype=torch.float32)
        back = train.restore_train_state(path, init_state(w.model))
        back, (loss1,) = w.run(None, back, steps=range(2, 3))
        same = [torch.equal(back.params[k], whole[k]) for k in whole]
        ok = all(same) and torch.equal(loss, loss1) and back.step == 3
        detail = (f"{sum(same)}/{len(same)} tensors bit-equal, loss "
                  f"{float(loss)} vs {float(loss1)}")
    w.record("checkpoint_4_ranks_to_1", ok, detail)


def main():
    spec = json.load(open(os.environ["SPEC"]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    w = World(spec)
    meshes = {name: make_mesh(4, ("dp", "fsdp", "tp"), shape)
              for name, shape in (("dp2_fsdp2", (2, 2, 1)),
                                  ("fsdp4", (1, 4, 1)),
                                  ("fsdp2_tp2", (1, 2, 2)))}
    ref = w.run(None)
    for name, mesh in meshes.items():
        check_mesh(w, name, mesh, ref)
    check_uniform(w, "fsdp2_tp2", meshes["fsdp2_tp2"])
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
