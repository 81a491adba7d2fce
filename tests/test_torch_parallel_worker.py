"""One rank of tests/test_torch_parallel.py's 4-rank gloo world.

Run by that file in a subprocess (RANK / WORLD_SIZE / MASTER_* in the
environment, SPEC naming its spec.json); it defines no tests and imports
neither JAX nor the JAX package. Every rank makes every mesh, in one order
(process groups are made collectively), runs the checks of the meshes it
belongs to, and writes {check: {"ok", "detail"}} to rank<N>.json.
"""

import json
import os
import sys
import time
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.models.dit import nadit
from seedvr2_tpu_torch.models.vae import pipeline_vae
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE
from seedvr2_tpu_torch.ops.int8_matmul import quantize_dit_w8a8
from seedvr2_tpu_torch.ops.offload import StreamedNaDiT
from seedvr2_tpu_torch.ops.quant_matmul import (quantize_dit_affine4,
                                                quantize_dit_q8)
from seedvr2_tpu_torch.parallel.comm import broadcast, tp_reducer
from seedvr2_tpu_torch.parallel import mesh as mesh_lib
from seedvr2_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT, make_mesh
from seedvr2_tpu_torch.parallel.tp import tp_shard_dit
from seedvr2_tpu_torch.utils.debug import _rank_tag
from seedvr2_tpu_torch.utils.parity import psnr

F32 = torch.float32
TP4_HEADS = 20  # tests/test_torch_parallel.py's 3B-like tp4 case
TP_TIMEOUT_S = 5


def _tuples(kw):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}


class World:
    def __init__(self, spec):
        self.spec = spec
        self.rank = dist.get_rank()
        self.data = np.load(os.path.join(spec["out"], "inputs.npz"))
        self.results = {}
        self.heads = []
        self.dit_kw = _tuples(spec["dit_kw"])
        self.vae_kw = _tuples(spec["vae_kw"])

    def state(self, prefix):
        return {k[len(prefix) + 1:]: torch.from_numpy(self.data[k])
                for k in self.data.files if k.startswith(prefix + "/")}

    def record(self, name, ok, detail=""):
        self.results[name] = {"ok": bool(ok), "detail": str(detail)}

    # ------------------------------------------------------- pipeline

    def pipe_runner(self, streamed=False):
        vcfg, dcfg = tc.VAEConfig(**self.vae_kw), tc.DiTConfig(**self.dit_kw)
        vae = VideoAutoencoder(vcfg, dtype=F32)
        vae.load_state_dict(self.state("pipe_vae"), strict=True)
        dit = nadit.NaDiT(dcfg, dtype=F32)
        dit.load_state_dict(self.state("pipe_dit"), strict=True)
        sd = StreamedNaDiT(dit, keep_blocks=1, device="cpu") if streamed \
            else None
        return TRunner(None if streamed else dit, VideoVAE(vae, F32),
                       tc.RunnerConfig(dit=dcfg, vae=vcfg), compute_dtype=F32,
                       streamed_dit=sd, device="cpu")

    def frames(self, runner):
        d = self.data
        out, _ = cli.process_frames(
            runner, d["images"], {"pos": d["emb_pos"], "neg": d["emb_neg"]},
            resolution=32, seed=1, batch_size=5, temporal_overlap=2,
            color_correction="none", noise_override=list(d["noise"]))
        return out

    # ------------------------------------------------------------ DiT

    def dit_model(self, name, family, lane, heads):
        dh = 32 if heads == 2 else 8
        cfg = tc.small_test_config(family=family, heads=heads, head_dim=dh)
        model = nadit.NaDiT(cfg, dtype=F32)
        model.load_state_dict(self.state(f"{name}/dense"), strict=True)
        if lane == "q8":
            quantize_dit_q8(model, 16)
        elif lane == "q4k":
            quantize_dit_affine4(model, 16)
        elif lane == "w8a8":
            quantize_dit_w8a8(model, 16, 16)
        return model

    def one_step(self, name, model, mesh=None):
        d = self.data
        r = TRunner(model, None, tc.RunnerConfig(dit=model.cfg),
                    compute_dtype=F32, device="cpu")
        if mesh is not None:
            r.attach_mesh(mesh)
            assert r.tp is not None, "tensor parallelism did not engage"
        n, b = (torch.from_numpy(d[f"{name}/{k}"]) for k in ("noise", "blur"))
        txt = torch.from_numpy(d[f"{name}/txt"])
        return r.inference([n], [r.get_condition(n, b)], [txt], [txt],
                           cfg_scale=1.0, steps=1)[0].numpy()


def vae_oom_one_rank(w, mesh, g):
    """Device OOMs injected on one rank of the 4-rank decode: in an item
    wave (that rank tiles its item alone), then the next call's plans
    agreed (every rank tiles, the tiles spread), then in a tile wave (every
    rank retries with the shrunk tile). No rank hangs; every result equals
    the one-rank decode under the tiling that item got."""
    lats = [torch.randn((2, 6, 5, w.vae_kw["latent_channels"]), generator=g)
            for _ in range(4)]
    size = {px: VAETiling(decode_tiled=px > 0, decode_tile_size=(px, px)
                          if px else (32, 32), decode_tile_overlap=(8, 8))
            for px in (0, 32, 16)}
    one = w.pipe_runner()
    ref = {}
    for px, tiling in size.items():
        one.tiling = tiling
        ref[px] = [one.vae_decode([z])[0] for z in lats]
    r = w.pipe_runner()
    r.attach_mesh(mesh)
    r._MIN_TILE = 16
    r.tiling = size[0]
    decode = pipeline_vae._decode_slices
    area = {1: 16}.get(w.rank)  # latent area beyond which this rank fails

    def flaky(model, z, lowering):
        if area is not None and z.shape[2] * z.shape[3] > area:
            raise torch.cuda.OutOfMemoryError("injected")
        return decode(model, z, lowering)

    pipeline_vae._decode_slices = flaky
    try:
        first = r.vae_decode(lats)
        second = r.vae_decode(lats)
        area = {2: 4}.get(w.rank)
        retries = r.oom_retries
        third = r.vae_decode(lats)
    finally:
        pipeline_vae._decode_slices = decode
    ok = [all(torch.equal(a, b) for a, b in zip(got, want)) for got, want in (
        (first, [ref[32 if i == 1 else 0][i] for i in range(4)]),
        (second, ref[32]), (third, ref[16]))]
    w.record("vae_oom_one_rank",
             all(ok) and retries == (w.rank == 1)
             and r.oom_retries - retries == 4
             and r.tiling.decode_tile_size == (16, 16),
             f"equal per call {ok}, retries {retries} then "
             f"{r.oom_retries - retries}, tile {r.tiling.decode_tile_size}")


def vae_oom_blend_one_rank(w, mesh, g):
    """A device OOM on one rank of the 4-rank tiled decode outside a tile's
    compute: rank 2's first blend-buffer allocation fails. Every rank
    raises alike before any tile is shared and retries that item with the
    shrunk tile; no rank hangs, and each result equals the one-rank decode
    under the tiling its item got."""
    lats = [torch.randn((2, 6, 5, w.vae_kw["latent_channels"]), generator=g)
            for _ in range(2)]
    size = {px: VAETiling(decode_tiled=True, decode_tile_size=(px, px),
                          decode_tile_overlap=(8, 8)) for px in (32, 16)}
    one = w.pipe_runner()
    ref = {}
    for px, tiling in size.items():
        one.tiling = tiling
        ref[px] = [one.vae_decode([z])[0] for z in lats]
    r = w.pipe_runner()
    r.attach_mesh(mesh)
    r._MIN_TILE = 16
    r.tiling = size[32]
    buffer, calls = pipeline_vae._blend_buffer, []

    def flaky(shape, device):
        calls.append(shape)
        if w.rank == 2 and len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("injected")
        return buffer(shape, device)

    pipeline_vae._blend_buffer = flaky
    try:
        got = r.vae_decode(lats)
    finally:
        pipeline_vae._blend_buffer = buffer
    # the shrink sticks in the runner's tiling; the call's second item was
    # planned with the first, at 32 px
    ok = [torch.equal(a, b) for a, b in zip(got, (ref[16][0], ref[32][1]))]
    w.record("vae_oom_blend_one_rank",
             all(ok) and r.oom_retries == 1
             and r.tiling.decode_tile_size == (16, 16),
             f"equal per item {ok}, retries {r.oom_retries}, tile "
             f"{r.tiling.decode_tile_size}")


def tp_failure_one_rank(w, mesh, timeout_s):
    """Rank 3 raises inside a tp4 forward (at block 1): its partners, in
    the block's all-reduce on a mesh made with a bounded timeout, raise
    within it instead of waiting for the rank that left."""
    name = "tp4_dit_3b"
    model = w.dit_model(name, "dit_3b", "dense", TP4_HEADS)
    tp_shard_dit(model, mesh)
    d = w.data
    n, b = (torch.from_numpy(d[f"{name}/{k}"]) for k in ("noise", "blur"))
    vid = torch.cat([n, b, torch.ones_like(n[..., :1])], -1)[None]
    txt = torch.from_numpy(d[f"{name}/txt"])[None]
    dplan = nadit.upload_plan(nadit.build_dit_plan(
        model.cfg, tuple(n.shape[:3]), txt.shape[1]), model.cfg, "cpu")
    block = nadit._block_forward

    def flaky(blk, cfg, i, *a, **kw):
        if w.rank == 3 and i == 1:
            raise RuntimeError("injected failure")
        return block(blk, cfg, i, *a, **kw)

    nadit._block_forward = flaky
    t0 = time.perf_counter()
    try:
        nadit.nadit_forward(model, vid, txt, torch.full((1,), 1000.0), dplan,
                            tp=tp_reducer(mesh))
        outcome = "returned"
    except RuntimeError as e:
        outcome = str(e)
    finally:
        nadit._block_forward = block
    seconds = time.perf_counter() - t0
    if w.rank == 3:
        ok = outcome == "injected failure"
    else:
        ok = outcome not in ("returned", "injected failure") \
            and seconds < timeout_s + 60
    w.record("tp_failure_one_rank", ok,
             f"{outcome[:120]!r} after {seconds:.1f} s (timeout "
             f"{timeout_s} s)")


def _close(got, ref, tol):
    err = float(np.max(np.abs(got - ref)))
    ok = np.allclose(got, ref, rtol=tol, atol=tol)
    return ok, f"max abs {err:.3g} (tol {tol})"


@torch.no_grad()
def main():
    spec = json.load(open(os.environ["SPEC"]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    w = World(spec)
    rank = w.rank
    # every mesh, in one order on every rank
    m_dp4 = make_mesh(4, ("dp",), (4,))
    m_dp2tp2 = make_mesh(4, ("dp", "tp"), (2, 2))
    m_tp2 = make_mesh(2, ("dp", "tp"), (1, 2))
    m_tp4 = make_mesh(4, ("dp", "tp"), (1, 4))
    m_dp2 = make_mesh(2, ("dp",), (2,))
    # the failure case's mesh waits TP_TIMEOUT_S, not COLLECTIVE_TIMEOUT
    mesh_lib.COLLECTIVE_TIMEOUT = timedelta(seconds=TP_TIMEOUT_S)
    try:
        m_tp4_bounded = make_mesh(4, ("dp", "tp"), (1, 4))
    finally:
        mesh_lib.COLLECTIVE_TIMEOUT = COLLECTIVE_TIMEOUT
    m_cli = cli.build_mesh(SimpleNamespace(tensor_parallel=2,
                                           data_parallel="auto"), 4)
    # the CLI's groups wait COLLECTIVE_TIMEOUT, not gloo's 30 minutes
    waits = {line: g._get_backend(torch.device("cpu")).options._timeout
             for line, g in m_cli.groups.items()}
    w.record("cli_mesh_timeout",
             m_cli.shape == {"dp": 2, "tp": 2} and len(waits) >= 2
             and all(t == COLLECTIVE_TIMEOUT for t in waits.values()),
             f"{waits}")

    # attention heads as the kernels (plain versions here) see them
    attend = nadit.packed_window_attention_grad
    nadit.packed_window_attention_grad = \
        lambda qkv, heads, *a, **kw: (w.heads.append(heads),
                                      attend(qkv, heads, *a, **kw))[1]
    uni = nadit.attention
    nadit.attention = lambda q, *a, **kw: (w.heads.append(q.shape[-2]),
                                           uni(q, *a, **kw))[1]

    w.record("rank_tag", _rank_tag() == f" [rank{rank}]", _rank_tag())

    # whole pipeline: world size 1, dp4, dp1 x tp2 (ranks 0, 1), dp2 x tp2
    ws1 = w.frames(w.pipe_runner())
    r = w.pipe_runner()
    r.attach_mesh(m_dp4)
    dp4 = w.frames(r)
    w.record("pipeline_dp4_bit_equal",
             np.array_equal(dp4, ws1) and r.last_batch_sizes == [1],
             f"max diff {np.abs(dp4 - ws1).max():.3g}, DiT batches on this "
             f"rank {r.last_batch_sizes}")
    tp2 = None
    if m_tp2.member:
        r = w.pipe_runner()
        r.attach_mesh(m_tp2)
        tp2 = torch.from_numpy(w.frames(r))
    tp2 = broadcast(tp2, 0, m_dp4, "cpu").numpy()
    r = w.pipe_runner()
    r.attach_mesh(m_dp2tp2)
    dp2tp2 = w.frames(r)
    w.record("pipeline_dp2tp2_bit_equal",
             np.array_equal(dp2tp2, tp2) and r.tp is not None
             and r.last_batch_sizes == [1, 1],
             f"max diff {np.abs(dp2tp2 - tp2).max():.3g}, batches "
             f"{r.last_batch_sizes}")
    ref = w.data["jax_pipeline"]
    checks = [_close(x, ref, 1e-4) for x in (ws1, dp4, tp2, dp2tp2)]
    w.record("pipeline_vs_jax_mesh",
             all(c[0] for c in checks) and ws1.shape == ref.shape,
             "; ".join(c[1] for c in checks))

    # one-step DiTs against JAX's mesh runs
    for name, family, lane, tp, heads in spec["cases"]:
        mesh = m_tp2 if tp == 2 else m_tp4
        if not mesh.member:
            continue
        w.heads.clear()
        got = w.one_step(name, w.dit_model(name, family, lane, heads), mesh)
        local = heads // tp
        tol = 2e-5 if lane == "dense" else 1e-4
        ok, detail = _close(got, w.data[f"{name}/jax"], tol)
        ok = ok and set(w.heads) == {local}
        detail += f"; attention heads seen {sorted(set(w.heads))}"
        key = name if tp == 2 else f"{name}_{local}_heads"
        w.record(key, ok, detail)

    if m_tp2.member:
        # w8a8: test_tp.py's PSNR rule against the dense forward
        name = "tp2_dit_3b"
        dense = w.one_step(name, w.dit_model(name, "dit_3b", "dense", 2))
        single = w.one_step(name, w.dit_model(name, "dit_3b", "w8a8", 2))
        tpw = w.one_step(name, w.dit_model(name, "dit_3b", "w8a8", 2), m_tp2)
        rng_ = float(np.max(np.abs(dense))) or 1.0
        p_single = psnr(single, dense, rng_)
        p_tp = psnr(tpw, dense, rng_)
        w.record("tp2_w8a8_psnr", p_tp >= p_single - 2.0,
                 f"tp {p_tp:.2f} dB, single {p_single:.2f} dB")

        # the uniform plan (K9's plain version) at the local heads
        d = w.data
        model = w.dit_model(name, "dit_3b", "dense", 2)
        cfg = model.cfg
        dplan = nadit.upload_plan(nadit.build_dit_plan(
            cfg, (3, 8, 10), 7, uniform=True), cfg, "cpu")
        n, b = (torch.from_numpy(d[f"{name}/{k}"]) for k in ("noise",
                                                              "blur"))
        vid = torch.cat([n, b, torch.ones_like(n[..., :1])], -1)[None]
        txt = torch.from_numpy(d[f"{name}/txt"])[None]
        tt = torch.full((1,), 1000.0)
        base = nadit.nadit_forward(model, vid, txt, tt, dplan)
        tp_shard_dit(model, m_tp2)
        w.heads.clear()
        got = nadit.nadit_forward(model, vid, txt, tt, dplan,
                                  tp=tp_reducer(m_tp2))
        ok, detail = _close(got.numpy(), base.numpy(), 2e-5)
        w.record("tp2_uniform_plan", ok and set(w.heads) == {1},
                 f"{detail}; heads seen {sorted(set(w.heads))}")

    # the tiled VAE's tile waves over 4 ranks
    vae = w.pipe_runner().vae
    g = torch.Generator().manual_seed(5)
    x = torch.rand((1, 5, 48, 40, 3), generator=g) * 2 - 1
    z = torch.randn((1, 2, 6, 5, vae.cfg.latent_channels), generator=g)
    kw = dict(tiled=True, tile_size=(24, 24), tile_overlap=(8, 8))
    outs = {}
    for mesh in (None, m_dp4):
        for mode in ("uniform", "ref"):
            outs[mesh, mode] = (vae.encode(x, tile_mode=mode, mesh=mesh,
                                           **kw),
                                vae.decode(z, tile_mode=mode, mesh=mesh,
                                           **kw),
                                len(vae.last_encode_tiles),
                                len(vae.last_decode_tiles))
    same = all(torch.equal(a, b) for mode in ("uniform", "ref")
               for a, b in zip(outs[None, mode][:2], outs[m_dp4, mode][:2]))
    tiles = [outs[None, m][2:] for m in ("uniform", "ref")]
    w.record("tiled_vae_waves", same and min(min(t) for t in tiles) > 1,
             f"tiles (encode, decode) per mode {tiles}")
    vae_oom_one_rank(w, m_dp4, g)
    vae_oom_blend_one_rank(w, m_dp4, g)

    # BlockSwap under dp2
    if m_dp2.member:
        r = w.pipe_runner(streamed=True)
        r.attach_mesh(m_dp2)
        got = w.frames(r)
        w.record("blockswap_dp2", np.array_equal(got, ws1)
                 and r.mesh is m_dp2
                 and r.last_batch_sizes == [1, 1],
                 f"max diff {np.abs(got - ws1).max():.3g}")

    # last: its mesh's groups are left with a timed-out collective
    tp_failure_one_rank(w, m_tp4_bounded, TP_TIMEOUT_S)

    # the port reached nothing of the JAX package
    assert not any(m == "seedvr2_tpu" or m.startswith("seedvr2_tpu.")
                   for m in sys.modules)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(w.results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
