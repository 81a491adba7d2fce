"""The port's serving parallelism (seedvr2_tpu_torch/parallel/) against the
JAX package's, on the CPU.

The numpy helpers are pinned equal to the JAX copies (partition, factorize,
permute_qkv_cols), tp_compatible answers as JAX's does on the tiny trees of
every layout, and build_mesh / make_mesh refuse what JAX's refuse.

Then ONE gloo world of 4 port ranks runs in subprocesses that import
neither JAX nor the JAX package. The parent computes the JAX side on its 8
virtual CPU devices (the root conftest), each on the mesh the port's check
uses (tests/test_tp.py's _mesh), and hands the ranks seeded inputs,
JAX-layout parameters (as state dicts) and JAX's outputs in one .npz. The
ranks run every check on meshes over that one world:

 - whole-pipeline frames (13 frames, four batches) under dp4 and dp2 x tp2,
   bit-equal to the port's world-size-1 frames (dp4) and to its dp1 x tp2
   frames (dp2 x tp2: tp changes only the fp32 order of the reduction),
   each within 1e-4 of JAX's dp2 x tp2 pipeline;
 - the tp2 one-step DiT of the 3B and the 7B families within 2e-5 of JAX's
   tp=2 mesh run (test_tp.py's bound), q8 and q4k within 1e-4, and w8a8
   held to test_tp.py's PSNR rule against the dense forward;
 - tp4 at 20 heads (3B-like) and 24 heads (7B-like): the attention runs at
   5 and 6 local heads, within 2e-5 of JAX's tp=4 run;
 - the uniform window plan (K9's plain version) at local heads;
 - the tiled VAE's tile waves over 4 ranks, bit-equal to one rank, with
   an OOM on one rank in a tile wave and in a tiled call's blend buffer
   (every rank retries alike);
 - BlockSwap (StreamedNaDiT) under dp2, bit-equal to the resident DiT;
 - one rank failing inside a tp4 forward: its partners raise within the
   mesh's bounded timeout instead of waiting; the CLI's mesh's groups are
   bounded by COLLECTIVE_TIMEOUT.

Each check is reported per rank and read back by one test case each.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.configs import small_test_config as jsmall
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.dit.nadit import init_dit_params
from seedvr2_tpu.models.vae.pipeline_vae import VideoVAE as JVAE
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu.ops.int8_matmul import quantize_dit_params_w8a8
from seedvr2_tpu.ops.quant_matmul import (quantize_dit_params,
                                          quantize_dit_params_affine4)
from seedvr2_tpu.parallel import mesh as jmesh
from seedvr2_tpu.parallel import tp as jtp
from seedvr2_tpu.utils import partition as jpart
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core.configs import small_test_config as tsmall
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit.nadit import NaDiT
from seedvr2_tpu_torch.ops.int8_matmul import quantize_dit_w8a8
from seedvr2_tpu_torch.ops.quant_matmul import (quantize_dit_affine4,
                                                quantize_dit_q8)
from seedvr2_tpu_torch.parallel import mesh as tmesh
from seedvr2_tpu_torch.parallel import tp as ttp
from seedvr2_tpu_torch.utils import partition as tpart

from .test_torch_dit import random_params
from .test_torch_pipeline import DIT_KW, VAE_KW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------- pinned helpers

PARTITION_CASES = [
    ("partition_by_size", ([1, 2, 3, 4, 5], 2)),
    ("partition_by_size", ([1, 2, 3, 4], 2)),
    ("partition_by_size", ([1, 2], 5)),
    ("partition_by_size", ([], 3)),
    ("partition_by_size", (range(5), 3)),
    ("partition_by_size", ([1], 0)),
    ("partition_by_groups", ([1, 2, 3, 4, 5], 2)),
    ("partition_by_groups", ([1, 2], 4)),
    ("partition_by_groups", ([1], -1)),
    ("shift_list", ([1, 2, 3, 4, 5], 3)),
    ("shift_list", ([1, 2, 3], 5)),
    ("shift_list", ([1, 2, 3], 0)),
    ("shift_list", ([], 2)),
]


def _call(fn, args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name,args", PARTITION_CASES)
def test_partition_pinned_to_jax(name, args):
    """The cases of tests/test_partition.py, errors included."""
    assert _call(getattr(tpart, name), args) == \
        _call(getattr(jpart, name), args)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 30, 64])
@pytest.mark.parametrize("ways", [1, 2, 3])
def test_factorize_pinned_to_jax(n, ways):
    assert list(tmesh.factorize(n, ways)) == list(jmesh.factorize(n, ways))


@pytest.mark.parametrize("heads,dh,tp", [(4, 6, 2), (20, 8, 4), (24, 4, 4),
                                         (6, 3, 3)])
def test_permute_qkv_cols_pinned_to_jax(heads, dh, tp):
    w = np.random.default_rng(heads).standard_normal((5, 3 * heads * dh))
    np.testing.assert_array_equal(ttp.permute_qkv_cols(w, heads, dh, tp),
                                  jtp.permute_qkv_cols(w, heads, dh, tp))
    b = w[0]
    np.testing.assert_array_equal(ttp.permute_qkv_cols(b, heads, dh, tp),
                                  jtp.permute_qkv_cols(b, heads, dh, tp))


def _trees(family, lane, heads=2, head_dim=32, vid_dim=64):
    """The JAX tree of the lane and the port's NaDiT holding the same
    numbers (quantised by each package's own converter, bit-equal)."""
    jcfg = jsmall(family=family, heads=heads, head_dim=head_dim,
                  vid_dim=vid_dim)
    dense = random_params(lambda k: init_dit_params(k, jcfg,
                                                    dtype=jnp.float32), 4)
    model = NaDiT(tsmall(family=family, heads=heads, head_dim=head_dim,
                         vid_dim=vid_dim), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(dense), strict=True)
    if lane == "q8":
        return jcfg, quantize_dit_params(dense, min_dim=16), \
            quantize_dit_q8(model, 16)
    if lane == "q4k":
        return jcfg, quantize_dit_params_affine4(dense, min_dim=16), \
            quantize_dit_affine4(model, 16)
    if lane == "w8a8":
        return jcfg, quantize_dit_params_w8a8(dense, min_dim=16, align=16), \
            quantize_dit_w8a8(model, 16, 16)
    return jcfg, dense, model


@pytest.mark.parametrize("lane", ["dense", "q8", "q4k", "w8a8"])
@pytest.mark.parametrize("family", ["dit_3b", "dit_7b"])
def test_tp_compatible_matches_jax(family, lane):
    """Every layout of the tiny 3B / 7B trees: the same verdict at tp 1..8
    (on the CPU, where neither package asks its kernels' extents)."""
    jcfg, tree, model = _trees(family, lane)
    for tp in range(1, 9):
        assert ttp.tp_compatible(model, tp) == \
            jtp.tp_compatible(tree, jcfg, tp), tp


def test_tp_compatible_asks_the_kernels_on_a_card():
    """On a card the local product must suit the layout's kernel: a w8a8
    row shard of local K = 16 is refused there (K3 needs K % 32), taken on
    the CPU; a dense tree shards either way."""
    _, _, model = _trees("dit_3b", "w8a8")
    assert ttp.tp_compatible(model, 2, "cpu")
    assert not ttp.tp_compatible(model, 4, "cuda")
    _, _, dense = _trees("dit_3b", "dense")
    assert ttp.tp_compatible(dense, 2, "cuda")


def test_make_mesh_refuses_a_shape_that_does_not_lay_out_n():
    with pytest.raises(ValueError, match="does not lay out 4 devices"):
        tmesh.make_mesh(4, ("dp", "tp"), shape=(3, 1))
    with pytest.raises(ValueError, match="does not lay out 4 devices"):
        jmesh.make_mesh(4, ("dp", "tp"), shape=(3, 1))
    one = tmesh.make_mesh(1, ("dp", "tp"), shape=(1, 1))
    assert one.shape == {"dp": 1, "tp": 1} and one.member
    assert one.group("tp") is None and one.coords() == {"dp": 0, "tp": 0}


@pytest.mark.parametrize("argv,n,message", [
    (["--tensor_parallel", "2"], 1, "does not divide the 1 local devices"),
    (["--tensor_parallel", "3"], 4, "does not divide the 4 local devices"),
])
def test_build_mesh_errors_match_jax(argv, n, message):
    import inference_cli

    sys_argv = sys.argv
    sys.argv = ["inference_cli.py", "in.png", *argv]
    try:
        jargs = inference_cli.parse_arguments()
    finally:
        sys.argv = sys_argv
    targs = cli.parse_arguments(["in.png", *argv])
    with pytest.raises(ValueError) as jerr:
        inference_cli.build_mesh(jargs, n)
    with pytest.raises(ValueError) as terr:
        cli.build_mesh(targs, n)
    assert message in str(terr.value) and str(terr.value) == str(jerr.value)


def test_build_mesh_one_device_is_none():
    for argv in ([], ["--data_parallel", "off"]):
        assert cli.build_mesh(cli.parse_arguments(["in.png", *argv]), 1) \
            is None


def test_cli_tensor_parallel_on_one_device_exits_2(tmp_path, capsys):
    """JAX's message and exit code, before any model is built."""
    path = tmp_path / "in.npy"
    np.save(path, np.zeros((1, 8, 8, 3), np.float32))
    with pytest.raises(SystemExit) as e:
        cli.main([str(path), "--device", "cpu", "--tensor_parallel", "2"])
    assert e.value.code == 2
    assert "--tensor_parallel 2 does not divide the 1 local devices" in \
        capsys.readouterr().err


def test_tensor_parallel_check_matches_jax():
    import inference_cli

    sys_argv = sys.argv
    sys.argv = ["inference_cli.py", "in.png", "--tensor_parallel", "0"]
    try:
        with pytest.raises(SystemExit) as j:
            inference_cli.parse_arguments()
    finally:
        sys.argv = sys_argv
    with pytest.raises(SystemExit) as t:
        cli.parse_arguments(["in.png", "--tensor_parallel", "0"])
    assert j.value.code == t.value.code == 2


# ------------------------------------------------------- the gloo world

WORLD = 4
FRAMES = 13        # batches of 5 with overlap 2: four same-shape batches
TP4_HEADS = {"dit_3b": 20, "dit_7b": 24}

CHECKS = ["pipeline_dp4_bit_equal", "pipeline_dp2tp2_bit_equal",
          "pipeline_vs_jax_mesh", "tp2_dit_3b", "tp2_dit_7b", "tp2_q8",
          "tp2_q4k", "tp2_w8a8_psnr", "tp4_dit_3b_5_heads",
          "tp4_dit_7b_6_heads", "tp2_uniform_plan", "tiled_vae_waves",
          "vae_oom_one_rank", "vae_oom_blend_one_rank", "blockswap_dp2",
          "rank_tag", "tp_failure_one_rank", "cli_mesh_timeout"]


def _jmesh(dp, tp):
    devs = np.asarray(jax.devices()[:dp * tp]).reshape(dp, 1, tp)
    return JMesh(devs, ("dp", "fsdp", "tp"))


def _one_step(runner, noise, cond, txt):
    return np.asarray(runner.inference(
        noises=[noise], conditions=[cond], texts_pos=[txt], texts_neg=[txt],
        cfg_scale=1.0, steps=1)[0])


def _jax_dit(cfg, params, mesh, noise, blur, txt):
    r = JRunner(params, cfg, vae=None, config=JRunnerConfig(dit=cfg),
                compute_dtype=jnp.float32)
    r.attach_mesh(mesh)
    assert r.tp_specs is not None
    n, b = jnp.asarray(noise), jnp.asarray(blur)
    return _one_step(r, n, r.get_condition(n, b), jnp.asarray(txt))


def _save_state(out, prefix, tree):
    for k, v in state_dict_from_jax(tree).items():
        out[f"{prefix}/{k}"] = v.numpy()


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["SEEDVR2_REPO"])
from tests.test_torch_parallel_worker import main
main()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side, then one run of the 4-rank gloo world: {check: [each
    rank's {"ok", "detail"}]}."""
    d = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    data = {}
    # whole pipeline: the tiny runner of tests/test_torch_pipeline.py
    jv_cfg, jd_cfg = JVAEConfig(**VAE_KW), JDiTConfig(**DIT_KW)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), 2)
    dit_p = random_params(lambda k: init_dit_params(k, jd_cfg,
                                                    dtype=jnp.float32), 3)
    images = rng.uniform(0, 1, (FRAMES, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 16)).astype(np.float32),
           "neg": rng.standard_normal((9, 16)).astype(np.float32)}
    noise = np.stack([rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
                      for _ in range(4)])
    j_runner = JRunner(dit_p, jd_cfg, JVAE(vae_p, jv_cfg, dtype=jnp.float32),
                       JRunnerConfig(dit=jd_cfg, vae=jv_cfg),
                       compute_dtype=jnp.float32)
    j_runner.attach_mesh(_jmesh(2, 2))
    assert j_runner.tp_specs is not None
    ctx = jp.setup_generation_context()
    ctx = jp.encode_all_batches(j_runner, ctx, images, batch_size=5,
                                temporal_overlap=2, resolution=32, seed=1,
                                color_correction="none")
    ctx["text_embeds"] = emb
    ctx = jp.upscale_all_batches(j_runner, ctx, seed=1,
                                 noise_override=list(noise))
    ctx = jp.decode_all_batches(j_runner, ctx)
    ctx = jp.postprocess_all_batches(ctx, color_correction="none",
                                     temporal_overlap=2, batch_size=5)
    data.update(images=images, emb_pos=emb["pos"], emb_neg=emb["neg"],
                noise=noise, jax_pipeline=ctx["final_video"])
    _save_state(data, "pipe_vae", vae_p)
    _save_state(data, "pipe_dit", dit_p)
    # one-step DiTs: tp2 in every lane, tp4 at 20 / 24 heads
    cases = [(f"tp2_{f}", f, "dense", 2, 2) for f in ("dit_3b", "dit_7b")]
    cases += [(f"tp2_{q}", "dit_3b", q, 2, 2) for q in ("q8", "q4k")]
    cases += [(f"tp4_{f}", f, "dense", 4, TP4_HEADS[f])
              for f in ("dit_3b", "dit_7b")]
    for name, family, lane, tp, heads in cases:
        dh = 32 if heads == 2 else 8
        jcfg, tree, _ = _trees(family, lane, heads, dh)
        shape = (3, 8, 10, jcfg.vid_out_channels)
        nz, bl = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        txt = rng.standard_normal((7, jcfg.txt_in_dim)).astype(np.float32)
        data[f"{name}/noise"], data[f"{name}/blur"] = nz, bl
        data[f"{name}/txt"] = txt
        data[f"{name}/jax"] = _jax_dit(jcfg, tree, _jmesh(1, tp), nz, bl, txt)
        _, dense, _ = _trees(family, "dense", heads, dh)
        _save_state(data, f"{name}/dense", dense)
    np.savez(d / "inputs.npz", **data)
    spec = {"dit_kw": DIT_KW, "vae_kw": VAE_KW, "cases": cases,
            "out": str(d)}
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
def test_gloo_world(world, check):
    """Each check of the 4-rank world passed on every rank that ran it."""
    assert check in world, f"{check} did not run"
    bad = [(rank, res["detail"]) for rank, res in world[check]
           if not res["ok"]]
    assert not bad, bad


@pytest.mark.parametrize("argv,cards,workers", [
    ([], 4, 4), ([], 1, 0), (["--data_parallel", "off"], 4, 0),
    (["--data_parallel", "off", "--tensor_parallel", "2"], 4, 2),
    (["--tensor_parallel", "2"], 8, 8), (["--device", "cpu"], 4, 0),
    (["--num_hosts", "2"], 4, 4), (["--num_hosts", "2", "--join_parts"], 4, 0),
    (["--tensor_parallel", "8"], 4, 4)])
def test_cli_starts_one_worker_a_card(monkeypatch, argv, cards, workers):
    """Outside a launcher, a host with more than one card starts one worker
    a card the flags ask for (dp auto: every card; off: the tp ones; a
    --num_hosts host too, the join not); under torchrun (WORLD_SIZE set)
    the launcher's processes serve."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    args = cli.parse_arguments(["in.npy", *argv])
    assert cli._local_workers(args) == workers
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert cli._local_workers(args) == 0


def test_cli_refuses_a_tp_that_does_not_divide_the_cards(monkeypatch,
                                                         tmp_path, capsys):
    """Before starting workers: JAX's message and exit code."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    path = tmp_path / "in.npy"
    np.save(path, np.zeros((1, 8, 8, 3), np.float32))
    with pytest.raises(SystemExit) as e:
        cli.main([str(path), "--tensor_parallel", "3"])
    assert e.value.code == 2
    assert "--tensor_parallel 3 does not divide the 4 local devices" in \
        capsys.readouterr().err
