"""Host-memory weight tiering (ops/offload.py, the runner's offload surface
and the pipeline's hooks) against the port's resident DiT, bit for bit, and
against the JAX package's StreamedNaDiT and runner on the same weights, on
the CPU in fp32 with tiny configs. On the CPU the streamed DiT runs with
host buffers as its slots and plain copies, so the packing, the views, the
slot rotation and the telemetry run here; tests/test_torch_cuda.py holds
the streams and events to the same outputs on the card."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.model_manager import _tree_bytes as j_tree_bytes
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.models.vae.pipeline_vae import VideoVAE as JVAE
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu.ops.int8_matmul import quantize_dit_params_w8a8
from seedvr2_tpu.ops.offload import StreamedNaDiT as JStreamed
from seedvr2_tpu.ops.quant_matmul import quantize_dit_params
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE as TVAE
from seedvr2_tpu_torch.ops import offload
from seedvr2_tpu_torch.ops.int8_matmul import W8A8Linear, quantize_dit_w8a8
from seedvr2_tpu_torch.ops.quant_matmul import Q8Linear, quantize_dit_q8

from .test_torch_dit import random_params

# three layers (block 0 vid / txt, blocks 1-2 shared, block 2 video only),
# width 32 so that the w8a8 (min_dim 8, align 8) and q8 (min_dim 16)
# conversions reach the attention, MLP and time-embedding linears
DIT_KW = dict(family="dit_3b", vid_in_channels=9, vid_out_channels=4,
              vid_dim=32, txt_in_dim=32, heads=2, head_dim=16,
              expand_ratio=4, patch_size=(1, 2, 2), num_layers=3,
              mm_layers=1, mlp_type="swiglu", window=(2, 2, 2),
              rope_type="mmrope3d", rope_dim=16, vid_out_norm=True)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
              latent_channels=4, norm_num_groups=4)
W8A8_MIN_DIM, W8A8_ALIGN, Q8_MIN_DIM = 8, 8, 16
T, H, W, L = 3, 8, 8, 5


def _jax_tree(lane, seed=0):
    params = random_params(lambda k: jn.init_dit_params(
        k, JDiTConfig(**DIT_KW), dtype=jnp.float32), seed)
    if lane == "w8a8":
        return quantize_dit_params_w8a8(params, W8A8_MIN_DIM, W8A8_ALIGN)
    if lane == "q8":
        return quantize_dit_params(params, min_dim=Q8_MIN_DIM)
    return params


def port_dit(lane, seed=0):
    """(JAX tree, the port's NaDiT on the same weights) for a lane: fp32,
    bf16 (the fp32 weights rounded), w8a8 or q8 (the JAX conversion's
    tree loaded over the port's own conversion)."""
    jtree = _jax_tree("fp32" if lane == "bf16" else lane, seed)
    model = tn.NaDiT(tc.DiTConfig(**DIT_KW), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(_jax_tree("fp32", seed)),
                          strict=True)
    if lane == "w8a8":
        quantize_dit_w8a8(model, W8A8_MIN_DIM, W8A8_ALIGN)
        model.load_state_dict(state_dict_from_jax(jtree), strict=True)
    elif lane == "q8":
        quantize_dit_q8(model, Q8_MIN_DIM)
        model.load_state_dict(state_dict_from_jax(jtree), strict=True)
    elif lane == "bf16":
        model = model.to(torch.bfloat16)
    return jtree, model


def _inputs(dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((1, T, H, W, 9)).astype(np.float32)
    txt = rng.standard_normal((1, L, 32)).astype(np.float32)
    return (vid, txt, np.array([500.0], np.float32),
            torch.from_numpy(vid).to(dtype), torch.from_numpy(txt).to(dtype),
            torch.tensor([500.0]))


@pytest.mark.parametrize("keep", [0, 1, 3])
@pytest.mark.parametrize("lane", ["fp32", "bf16", "w8a8", "q8"])
def test_streamed_nadit_matches_resident_and_jax(lane, keep):
    """The streamed DiT, keep_blocks of 0 (every block streamed, an odd
    count, so the second forward rotates the slots the other way), 1 and
    all, equals the resident port forward bit for bit in both forwards,
    the quantised buffers surviving the packing; and, at keep 1 (kept and
    streamed blocks), lies within 1e-5 of JAX's StreamedNaDiT on the same
    tree (fp32 lanes), as tests/test_components.py holds JAX's to its
    regular forward."""
    jtree, model = port_dit(lane)
    dtype = torch.bfloat16 if lane == "bf16" else torch.float32
    jvid, jtxt, jt, vid, txt, t = _inputs(dtype)
    cfg = model.cfg
    dplan = tn.upload_plan(tn.build_dit_plan(cfg, (T, H, W), L), cfg, "cpu")
    with torch.no_grad():
        ref = tn.nadit_forward(model, vid, txt, t, dplan)
    streamed = offload.StreamedNaDiT(copy.deepcopy(model), keep_blocks=keep,
                                     device="cpu")
    assert streamed.keep_blocks == keep and len(streamed.host) == 3 - keep
    rotations = []
    for _ in range(2):
        rotations.append(streamed._next_slot)
        out = streamed(vid, txt, t, dplan)
        assert torch.equal(out, ref)
    if keep == 0:
        assert rotations == [0, 1]
    assert streamed.stats.summary()["total_swaps"] == 2 * (3 - keep)
    if lane == "w8a8":
        assert any(isinstance(m, W8A8Linear) and hasattr(m, "gate_up_w8a8")
                   for m in streamed.model.modules())
    if lane == "q8":
        assert any(isinstance(m, Q8Linear) for m in streamed.model.modules())
    if lane == "bf16" or keep != 1:
        return
    jplan = jn.build_dit_plan(JDiTConfig(**DIT_KW), (T, H, W), L)
    jout = JStreamed(jtree, JDiTConfig(**DIT_KW), keep_blocks=keep)(
        jnp.asarray(jvid), jnp.asarray(jtxt), jnp.asarray(jt), jplan)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_streamed_blocks_are_slot_views_and_host_packs():
    """Each streamed block lives in one host pack (its module's tensors are
    views of it, K3's joined gate / up and its halves one storage), each
    shell's tensors are views of its slot, the slots hold the largest
    block, and the kept blocks and IO parameters are left in place."""
    _, model = port_dit("w8a8")
    streamed = offload.StreamedNaDiT(model, keep_blocks=1, device="cpu")
    for pack, blk in zip(streamed.host, model.blocks[1:]):
        ptrs = {t.untyped_storage().data_ptr()
                for t in list(blk.parameters()) + list(blk.buffers())}
        assert ptrs == {pack.buffer.untyped_storage().data_ptr()}
    assert streamed.slots[0].numel() == max(p.nbytes for p in streamed.host)
    for j, shells in enumerate(streamed.shells):
        for slot, shell in zip(streamed.slots, shells):
            for t in list(shell.parameters()) + list(shell.buffers()):
                assert (t.untyped_storage().data_ptr()
                        == slot.untyped_storage().data_ptr())
    gate = model.blocks[1].mlp["all"].proj_in_gate
    assert gate.w8a8.untyped_storage().data_ptr() == \
        gate.gate_up_w8a8.untyped_storage().data_ptr()
    assert streamed.resident_bytes() == (
        offload.module_bytes(model) - sum(
            offload.module_bytes(b) for b in model.blocks[1:])
        + 2 * streamed.slots[0].numel())


@pytest.mark.parametrize("lane", ["fp32", "w8a8", "q8"])
def test_module_bytes_match_jax_tree_bytes(lane):
    """The planner's byte count (every parameter and buffer, K3's joined
    gate / up counted once with its halves) equals the JAX tree's."""
    jtree, model = port_dit(lane)
    assert offload.module_bytes(model) == j_tree_bytes(jtree)
    for i, blk in enumerate(model.blocks):
        assert offload.module_bytes(blk) == j_tree_bytes(jtree["blocks"][i])


def test_swap_stats_summary_keys_match_jax():
    """SwapStats.summary() has the JAX keys, counts a swap per streamed
    block per forward, and the empty summary is JAX's."""
    from seedvr2_tpu.ops.offload import SwapStats as JStats

    jtree, model = port_dit("fp32")
    jvid, jtxt, jt, vid, txt, t = _inputs()
    assert offload.SwapStats().summary() == JStats().summary()
    streamed = offload.StreamedNaDiT(model, keep_blocks=1, device="cpu")
    dplan = tn.upload_plan(tn.build_dit_plan(model.cfg, (T, H, W), L),
                           model.cfg, "cpu")
    streamed(vid, txt, t, dplan)
    jplan = jn.build_dit_plan(JDiTConfig(**DIT_KW), (T, H, W), L)
    js = JStreamed(jtree, JDiTConfig(**DIT_KW), keep_blocks=1)
    js(jnp.asarray(jvid), jnp.asarray(jtxt), jnp.asarray(jt), jplan)
    ours, theirs = streamed.stats.summary(), js.stats.summary()
    assert ours.keys() == theirs.keys()
    assert ours["block_swaps"] == theirs["block_swaps"] == 2
    assert ours["block_bytes"] >= theirs["block_bytes"] > 0
    tr = streamed.stats.transfer()
    assert tr["copies"] == 2 and tr["copy_gbps"] > 0


def _runners(seed=5, **kw):
    """(JAX runner, port runner) on the same fp32 DiT, no VAE."""
    jtree, model = port_dit("fp32", seed)
    jcfg = JDiTConfig(**DIT_KW)
    jr = JRunner(jtree, jcfg, None, JRunnerConfig(dit=jcfg, vae=JVAEConfig()),
                 compute_dtype=jnp.float32)
    tr = TRunner(model, None, tc.RunnerConfig(dit=model.cfg),
                 compute_dtype=torch.float32)
    return jr, tr


def _denoise_inputs(runner, seed):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    txt = rng.standard_normal((5, 32)).astype(np.float32)
    n = torch.from_numpy(noise)
    return noise, txt, [n], [runner.get_condition(n, n)], [txt]


def test_runner_streamed_blockswap_matches_regular():
    """A runner built with streamed_dit (the product BlockSwap path wired by
    configure_runner) reproduces the regular runner's denoise output bit for
    bit and JAX's within 1e-5, and records a swap per streamed block
    (test_components.py's test of the same name)."""
    jr, regular = _runners()
    streamed = TRunner(None, None, regular.config,
                       compute_dtype=torch.float32,
                       streamed_dit=offload.StreamedNaDiT(
                           copy.deepcopy(regular.dit), keep_blocks=2,
                           device="cpu"))
    assert streamed.dit is streamed.streamed_dit.model
    assert streamed.device == torch.device("cpu")
    noise, txt, noises, conds, txts = _denoise_inputs(regular, 5)
    ref = regular.inference(noises, conds, txts, txts, cfg_scale=1.0,
                            steps=1)
    out = streamed.inference(noises, conds, txts, txts, cfg_scale=1.0,
                             steps=1)
    assert torch.equal(out[0], ref[0])
    jn_ = jnp.asarray(noise)
    jout = jr.inference([jn_], [jr.get_condition(jn_, jn_)], [txt], [txt],
                        cfg_scale=1.0, steps=1)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-5, atol=1e-5)
    stats = streamed.streamed_dit.stats.summary()
    assert stats["block_swaps"] == 1  # 3 layers, 2 resident
    assert stats["block_bytes"] > 0


def test_runner_phase_offload_roundtrip():
    """Per-phase DiT offload (set_phase_offload / release_dit /
    ensure_dit_resident): the DiT's tensors point at ONE host copy made
    once while released, inference restores them into one device buffer
    and reproduces the always-resident result, and a second round trip
    reuses the same host copy (test_components.py's test of the same
    name)."""
    jr, regular = _runners(seed=6)
    offl = TRunner(copy.deepcopy(regular.dit), None, regular.config,
                   compute_dtype=torch.float32, device="cpu")
    offl.set_phase_offload()
    host = offl._host_dit.packed.buffer

    def storages():
        return {t.untyped_storage().data_ptr()
                for t in list(offl.dit.parameters()) + list(offl.dit.buffers())}

    assert storages() == {host.untyped_storage().data_ptr()}
    noise, txt, noises, conds, txts = _denoise_inputs(regular, 6)
    ref = regular.inference(noises, conds, txts, txts, cfg_scale=1.0,
                            steps=1)
    out = offl.inference(noises, conds, txts, txts, cfg_scale=1.0, steps=1)
    assert torch.equal(out[0], ref[0])
    assert offl._host_dit.resident and len(offl.restore_seconds) == 1
    dev = offl._host_dit._device_buf.untyped_storage().data_ptr()
    assert storages() == {dev}
    offl.release_dit()
    assert not offl._host_dit.resident
    assert storages() == {host.untyped_storage().data_ptr()}
    out2 = offl.inference(noises, conds, txts, txts, cfg_scale=1.0, steps=1)
    assert torch.equal(out2[0], ref[0])
    assert offl._host_dit.packed.buffer is host
    assert len(offl.restore_seconds) == 2
    regular.release_dit()  # a no-op without phase offload
    assert not regular.phase_offload and regular.restore_seconds == []


def _vae_pair(seed=2):
    jv_cfg = JVAEConfig(**VAE_KW)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), seed)
    vae = VideoAutoencoder(tc.VAEConfig(**VAE_KW), dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    return JVAE(vae_p, jv_cfg, dtype=jnp.float32), TVAE(vae, torch.float32)


def test_pipeline_offload_hooks_and_summary(caplog):
    """The 4 phases with a phase-offloaded DiT: the VAE phases run with the
    DiT released (checked inside encode and decode), phase 2 restores it
    ("dit_restore" in the timings), and the output equals the resident
    runner's; with a streamed DiT phase 2 logs the BlockSwap line and adds
    the blocks' stall ("dit_swap_stall"); both equal the resident output."""
    _, tvae = _vae_pair()
    _, model = port_dit("fp32", 3)
    rcfg = tc.RunnerConfig(dit=model.cfg, vae=tvae.cfg)
    kw = dict(compute_dtype=torch.float32)
    regular = TRunner(model, tvae, rcfg, **kw)
    offl = TRunner(copy.deepcopy(model), tvae, rcfg, device="cpu", **kw)
    offl.set_phase_offload()
    streamed = TRunner(None, tvae, rcfg, streamed_dit=offload.StreamedNaDiT(
        copy.deepcopy(model), keep_blocks=1, device="cpu"), **kw)
    seen = []
    encode, decode = tvae.encode, tvae.decode

    def spy(fn):
        def call(*a, **k):
            seen.append(offl._host_dit.resident)
            return fn(*a, **k)
        return call

    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (5, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 32)).astype(np.float32),
           "neg": rng.standard_normal((9, 32)).astype(np.float32)}
    run = dict(resolution=32, seed=1, batch_size=5, color_correction="none")
    ref, timings = cli.process_frames(regular, images, emb, **run)
    # the record's top level: the request, its phases and the two copy
    # counters (their steps are dotted under them; tests/test_torch_spans)
    assert {k for k in timings if "." not in k} == {
        "request", "encode", "dit", "decode", "postprocess", "h2d_bytes",
        "d2h_bytes"}
    tvae.encode, tvae.decode = spy(encode), spy(decode)
    try:
        out, timings = cli.process_frames(offl, images, emb, **run)
    finally:
        tvae.encode, tvae.decode = encode, decode
    assert seen == [False, False]
    assert "dit_restore" in timings and np.array_equal(out, ref)
    with caplog.at_level("INFO", logger="seedvr2_tpu_torch.core.pipeline"):
        out, timings = cli.process_frames(streamed, images, emb, **run)
    assert np.array_equal(out, ref)
    assert timings["dit_swap_stall"] >= 0.0
    assert any("BlockSwap: 2 swaps" in r.message for r in caplog.records)
