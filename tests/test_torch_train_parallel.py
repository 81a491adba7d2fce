"""The port's trainer over a mesh: ONE gloo world of 4 port ranks, on the CPU.

The world runs in subprocesses that import neither JAX nor the JAX package
(tests/test_torch_train_parallel_worker.py). The parent writes the tiny
DiT of tests/test_torch_train.py (seeded JAX-layout values carried across
by the weight bridge) and a batch of 2, and each rank checks:

 - three fp32 steps on the (dp, fsdp, tp) meshes (2, 2, 1), (1, 4, 1),
   (1, 2, 2), (1, 1, 2) and (2, 1, 2), on the grouped and on the uniform
   window plan, against the same steps on one rank: losses, whole
   parameters and each rank's gradient piece of the first step against
   its piece of one rank's whole gradient, within 1e-6 (the dp sum of the
   gradients and the tp sums of the partials run in another order than
   one rank's backward); each rank holding 1 / (fsdp * tp) of every
   tensor cut both ways, its parameters and both moments alike;
 - on (1, 4, 1), fsdp alone at dp 1: both plans bit-equal to one rank;
 - on (1, 4, 1) and (1, 2, 2): each block's weights gathered twice a
   step, the gathered bytes alive at once at most two blocks' and the
   parameters outside the blocks (counted by their storage), and no
   whole parameter gathered in a step;
 - on (1, 1, 2) and (1, 2, 2): the local NaDiT's weights at the tp pieces'
   shapes;
 - a checkpoint written by the world on (1, 2, 2) after two steps:
   restored onto the mesh it steps on bit-equal; restored on one rank its
   parameters are the saved ones and its third step lies within 1e-6 of
   the world's.

Each check is reported per rank and read back by one test case each.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu_torch.core.weights import (state_dict_from_jax,
                                            write_safetensors)

from .test_torch_dit import random_params
from .test_torch_train import BATCH, SHAPE, TINY, TXT_LEN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = ["dp2_fsdp2", "fsdp4", "fsdp2_tp2", "tp2", "dp2_tp2"]
CHECKS = ([f"train_{m}" for m in MESHES]
          + [f"train_uniform_{m}" for m in MESHES]
          + ["bit_equal_fsdp4", "gathers_fsdp4", "gathers_fsdp2_tp2",
             "local_shapes_tp2", "local_shapes_fsdp2_tp2",
             "checkpoint_4_ranks_to_1"])

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["SEEDVR2_REPO"])
from tests.test_torch_train_parallel_worker import main
main()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One run of the 4-rank gloo world: {check: [(rank, {"ok",
    "detail"})]}."""
    d = tmp_path_factory.mktemp("train_parallel")
    params = random_params(lambda k: jn.init_dit_params(
        k, JDiTConfig(**TINY), dtype=jnp.float32), 7)
    write_safetensors(str(d / "dit.safetensors"), state_dict_from_jax(params))
    rng = np.random.default_rng(5)
    t, h, w = SHAPE
    np.savez(d / "inputs.npz",
             latent=rng.standard_normal((BATCH, t, h, w, 4), np.float32),
             cond=rng.standard_normal((BATCH, t, h, w, 5), np.float32),
             txt=rng.standard_normal((BATCH, TXT_LEN, 16), np.float32))
    spec = {"cfg": TINY, "shape": SHAPE, "txt_len": TXT_LEN, "out": str(d)}
    (d / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, SEEDVR2_REPO=REPO, SPEC=str(d / "spec.json"),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(WORLD), RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    results = {}
    for rank in range(WORLD):
        got = json.loads((d / f"rank{rank}.json").read_text())
        for check, res in got.items():
            results.setdefault(check, []).append((rank, res))
    return results


@pytest.mark.parametrize("check", CHECKS)
def test_train_world(world, check):
    """Each check of the 4-rank world passed on every rank that ran it."""
    assert check in world and len(world[check]) == WORLD, \
        f"{check} did not run on every rank"
    bad = [(rank, res["detail"]) for rank, res in world[check]
           if not res["ok"]]
    assert not bad, bad
