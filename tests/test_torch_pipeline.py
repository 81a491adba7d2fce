"""The port's whole 4-phase slice (cli.process_frames: encode -> DiT ->
decode -> colour fix) against the JAX pipeline on the CPU in fp32, with the
tiny runner of tests/test_pipeline.py, shared weights and shared noise: the
default path, the throughput lane (w8a8 DiT + uniform tiled VAE) and the q8
and q4 lanes; plus the pipeline's batch math and the CLI's flags, preset
and refusal to run without a GPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.dit.nadit import init_dit_params
from seedvr2_tpu.models.vae.pipeline_vae import VideoVAE as JVAE
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu.ops.int8_matmul import quantize_dit_params_w8a8
from seedvr2_tpu.ops.quant_matmul import (quantize_dit_params,
                                          quantize_dit_params_affine4)
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core import pipeline as tp
from seedvr2_tpu_torch.core.runner import VAETiling
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit.nadit import NaDiT
from seedvr2_tpu_torch.ops.int8_matmul import W8A8Linear, quantize_dit_w8a8
from seedvr2_tpu_torch.ops.quant_matmul import (AffineLinear, Q8Linear,
                                                quantize_dit_affine4,
                                                quantize_dit_q8)
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE as TVAE

from .test_torch_dit import random_params

VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
              latent_channels=4, norm_num_groups=4)
DIT_KW = dict(family="dit_3b", vid_in_channels=9, vid_out_channels=4,
              vid_dim=24, txt_in_dim=16, heads=2, head_dim=12, expand_ratio=4,
              patch_size=(1, 2, 2), num_layers=2, mm_layers=1,
              mlp_type="swiglu", window=(2, 2, 2), rope_type="mmrope3d",
              rope_dim=12, vid_out_norm=True)


@pytest.fixture(scope="module")
def runners():
    jv_cfg, jd_cfg = JVAEConfig(**VAE_KW), JDiTConfig(**DIT_KW)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), 2)
    dit_p = random_params(lambda k: init_dit_params(k, jd_cfg,
                                                    dtype=jnp.float32), 3)
    j_runner = JRunner(dit_p, jd_cfg, JVAE(vae_p, jv_cfg, dtype=jnp.float32),
                       JRunnerConfig(dit=jd_cfg, vae=jv_cfg),
                       compute_dtype=jnp.float32)
    tv_cfg, td_cfg = tc.VAEConfig(**VAE_KW), tc.DiTConfig(**DIT_KW)
    vae = VideoAutoencoder(tv_cfg, dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    dit = NaDiT(td_cfg, dtype=torch.float32)
    dit.load_state_dict(state_dict_from_jax(dit_p), strict=True)
    t_runner = TRunner(dit, TVAE(vae, torch.float32),
                       tc.RunnerConfig(dit=td_cfg, vae=tv_cfg),
                       compute_dtype=torch.float32)
    return j_runner, t_runner


# the throughput lane at the tiny size: every DiT linear with both dims
# multiples of 8 goes w8a8 (vid_in, 36 inputs, stays dense), and the VAE
# tiles 24 px tiles with 8 px overlaps (latent 6x4 -> multi-tile grids)
W8A8_MIN_DIM, W8A8_ALIGN = 8, 8
TILE_KW = dict(tiled=True, tile_size=(24, 24), tile_overlap=(8, 8))


@pytest.fixture(scope="module")
def throughput_runners():
    jv_cfg, jd_cfg = JVAEConfig(**VAE_KW), JDiTConfig(**DIT_KW)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), 2)
    dit_p = random_params(lambda k: init_dit_params(k, jd_cfg,
                                                    dtype=jnp.float32), 3)
    qdit_p = quantize_dit_params_w8a8(dit_p, min_dim=W8A8_MIN_DIM,
                                      align=W8A8_ALIGN)
    j_runner = JRunner(
        qdit_p, jd_cfg, JVAE(vae_p, jv_cfg, dtype=jnp.float32),
        JRunnerConfig(dit=jd_cfg, vae=jv_cfg), compute_dtype=jnp.float32,
        encode_tiled=True, encode_tile_size=TILE_KW["tile_size"],
        encode_tile_overlap=TILE_KW["tile_overlap"], decode_tiled=True,
        decode_tile_size=TILE_KW["tile_size"],
        decode_tile_overlap=TILE_KW["tile_overlap"], tile_mode="uniform")
    tv_cfg, td_cfg = tc.VAEConfig(**VAE_KW), tc.DiTConfig(**DIT_KW)
    vae = VideoAutoencoder(tv_cfg, dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    dit = NaDiT(td_cfg, dtype=torch.float32)
    dit.load_state_dict(state_dict_from_jax(dit_p), strict=True)
    dit = quantize_dit_w8a8(dit, W8A8_MIN_DIM, W8A8_ALIGN)
    dit.load_state_dict(state_dict_from_jax(qdit_p), strict=True)
    tiling = VAETiling(encode_tiled=True, encode_tile_size=(24, 24),
                       encode_tile_overlap=(8, 8), decode_tiled=True,
                       decode_tile_size=(24, 24), decode_tile_overlap=(8, 8))
    t_runner = TRunner(dit, TVAE(vae, torch.float32),
                       tc.RunnerConfig(dit=td_cfg, vae=tv_cfg),
                       compute_dtype=torch.float32, tiling=tiling)
    return j_runner, t_runner


def _jax_pipeline(j_runner, images, emb, noise, color, overlap):
    ctx = jp.setup_generation_context()
    ctx = jp.encode_all_batches(j_runner, ctx, images, batch_size=5,
                                temporal_overlap=overlap, resolution=32,
                                color_correction=color, seed=1)
    ctx["text_embeds"] = emb
    ctx = jp.upscale_all_batches(j_runner, ctx, seed=1, noise_override=noise)
    ctx = jp.decode_all_batches(j_runner, ctx)
    ctx = jp.postprocess_all_batches(ctx, color_correction=color,
                                     temporal_overlap=overlap, batch_size=5)
    return ctx["final_video"]


@pytest.mark.parametrize("color", ["none", "lab"])
def test_slice_matches_jax_pipeline(runners, color):
    """7 frames of 24x20 to 32 px in batches of 5 with overlap 2: two
    batches, 4n+1 padding, overlap blending. Without colour correction the
    outputs agree to fp32 noise (1e-4); lab adds the histogram matching's
    rank swaps (see tests/test_torch_layers.py), so there 99% of the values
    are within 1e-4 (observed 99.85% on this small frame) and all within
    1e-2."""
    j_runner, t_runner = runners
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (7, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 16)).astype(np.float32),
           "neg": rng.standard_normal((9, 16)).astype(np.float32)}
    noise = [rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
             for _ in range(2)]
    ref = _jax_pipeline(j_runner, images, emb, noise, color, 2)
    out, timings = cli.process_frames(
        t_runner, images, emb, resolution=32, seed=1, batch_size=5,
        temporal_overlap=2, color_correction=color, noise_override=noise)
    assert out.shape == ref.shape == (7, 38, 32, 3)
    assert set(timings) == {"encode", "dit", "decode", "postprocess"}
    diff = np.abs(out - ref)
    if color == "none":
        assert diff.max() < 1e-4
    else:
        assert diff.max() < 1e-2 and (diff > 1e-4).mean() < 1e-2


def test_seeded_noise_is_reproducible(runners):
    """Without noise_override the port draws its noise from a seeded
    torch.Generator: the same seed gives the same output."""
    _, t_runner = runners
    images = np.random.default_rng(2).uniform(0, 1, (1, 24, 20, 3)).astype(
        np.float32)
    emb = {"pos": np.ones((3, 16), np.float32),
           "neg": np.zeros((3, 16), np.float32)}
    a, _ = cli.process_frames(t_runner, images, emb, resolution=32, seed=5)
    b, _ = cli.process_frames(t_runner, images, emb, resolution=32, seed=5)
    c, _ = cli.process_frames(t_runner, images, emb, resolution=32, seed=6)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 38, 32, 3) and np.abs(a - c).max() > 1e-4


def test_runner_condition_and_timestep_transform(runners):
    j_runner, t_runner = runners
    rng = np.random.default_rng(3)
    noise, lat = (rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
                  for _ in range(2))
    np.testing.assert_array_equal(
        t_runner.get_condition(torch.from_numpy(noise),
                               torch.from_numpy(lat)).numpy(),
        np.asarray(j_runner.get_condition(jnp.asarray(noise),
                                          jnp.asarray(lat))))
    shapes = np.array([[2, 6, 4]], np.float32)
    t = np.array([250.0], np.float32)
    np.testing.assert_allclose(
        t_runner.timestep_transform(torch.from_numpy(t),
                                    torch.from_numpy(shapes)).numpy(),
        np.asarray(j_runner.timestep_transform(jnp.asarray(t),
                                               jnp.asarray(shapes))),
        rtol=1e-6)


@pytest.mark.parametrize("total,batch,overlap", [
    (10, 5, 2), (10, 3, 5), (7, 5, 0), (1, 5, 0), (23, 5, 4)])
def test_batch_math_equal(total, batch, overlap):
    assert tp.batch_indices(total, batch, overlap) == jp.batch_indices(
        total, batch, overlap)
    video = np.arange(total, dtype=np.float32).reshape(total, 1, 1, 1)
    for count, prepend in ((0, False), (2, True), (3, False), (total + 2,
                                                               False)):
        np.testing.assert_array_equal(
            tp.pad_video_temporal(video, count, prepend),
            jp.pad_video_temporal(video, count, prepend))
    if overlap:
        a = np.ones((overlap, 2, 2, 3), np.float32)
        b = np.zeros((overlap, 2, 2, 3), np.float32)
        np.testing.assert_array_equal(
            tp.blend_overlapping_frames(a, b, overlap),
            jp.blend_overlapping_frames(a, b, overlap))


def test_cli_refuses_cuda_without_gpu(tmp_path, monkeypatch):
    """--device auto (the default, as in the JAX CLI) and cuda are the GPU
    and never fall back to the CPU."""
    path = tmp_path / "in.npy"
    np.save(path, np.zeros((1, 16, 16, 3), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(path), "--resolution", "32"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(path), "--resolution", "32", "--device", "cuda"])
    args = cli.parse_arguments([str(path)])
    assert (args.resolution, args.batch_size, args.seed,
            args.color_correction, args.device) == (1080, 5, 42, "lab",
                                                    "auto")


@pytest.mark.parametrize("color", ["none", "lab"])
def test_throughput_slice_matches_jax_pipeline(throughput_runners, color):
    """The throughput lane end to end: w8a8 DiT (the JAX-quantized tree
    carried over by the weight bridge) and the uniform tiled VAE, against
    the JAX runner built from the same tree with the same tile settings.
    Tolerance: the default path's, because K3 is exact and the fp32 K4/K5
    quantizations agree with XLA's except for +-1 flips where y / scale
    lands within rounding noise of .5, which this small input does not hit
    (observed max difference 2.9e-6 without colour correction); lab keeps
    the rank-swap allowance of test_slice_matches_jax_pipeline."""
    j_runner, t_runner = throughput_runners
    assert isinstance(t_runner.dit.blocks[0].attn.proj_qkv["vid"],
                      W8A8Linear)
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 1, (7, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 16)).astype(np.float32),
           "neg": rng.standard_normal((9, 16)).astype(np.float32)}
    noise = [rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
             for _ in range(2)]
    ref = _jax_pipeline(j_runner, images, emb, noise, color, 2)
    out, _ = cli.process_frames(
        t_runner, images, emb, resolution=32, seed=1, batch_size=5,
        temporal_overlap=2, color_correction=color, noise_override=noise)
    assert len(t_runner.vae.last_encode_tiles) > 1
    assert t_runner.vae.last_decode_tiles == j_runner.vae.last_decode_tiles
    assert len(t_runner.vae.last_decode_tiles) > 1
    assert out.shape == ref.shape == (7, 38, 32, 3)
    diff = np.abs(out - ref)
    if color == "none":
        assert diff.max() < 1e-4
    else:
        assert diff.max() < 1e-2 and (diff > 1e-4).mean() < 1e-2


def test_cli_throughput_preset_bundle(tmp_path):
    """--preset throughput sets the serving bundle where a flag was left at
    its default; explicit flags win."""
    path = str(tmp_path / "in.npy")
    plain = cli.parse_arguments([path])
    assert (plain.quant, plain.vae_encode_tiled, plain.vae_decode_tiled,
            plain.vae_decode_tile_size) == ("none", False, False, 1024)
    args = cli.parse_arguments([path, "--preset", "throughput",
                                "--vae_decode_tile_size", "512",
                                "--vae_encode_tile_overlap", "16"])
    for name, val in cli.THROUGHPUT_PRESET.items():
        if name not in ("vae_decode_tile_size", "vae_encode_tile_overlap"):
            assert getattr(args, name) == val, name
    assert args.vae_decode_tile_size == 512
    assert args.vae_encode_tile_overlap == 16
    assert cli.tiling_from_args(args) == VAETiling(
        encode_tiled=True, encode_tile_size=(1536, 1536),
        encode_tile_overlap=(16, 16), decode_tiled=True,
        decode_tile_size=(512, 512), decode_tile_overlap=(48, 48))
    # an explicit --quant wins over the preset's w8a8
    assert cli.parse_arguments([path, "--preset", "throughput", "--quant",
                                "q4"]).quant == "q4"
    with pytest.raises(SystemExit):
        cli.parse_arguments([path, "--quant", "q2"])


# the q8 / q4 lanes at the tiny size: width 32 so that K % 32 == 0 and the
# attention, mlp and time-embedding linears convert (min_dim 16); vid_in (36
# inputs) stays dense
QDIT_KW = dict(DIT_KW, vid_dim=32, head_dim=16, rope_dim=16, txt_in_dim=32)
Q_MIN_DIM = 16


@pytest.mark.parametrize("quant", ["q8", "q4"])
def test_quantised_slice_matches_jax_pipeline(quant):
    """The q8 (K6) and q4 (K7) lanes end to end: the JAX runner on the
    quantize_dit_params{,_affine4} tree, the port's runner on its own
    conversion of the same float weights (bit-equal, tests/
    test_torch_quant_matmul.py) with the JAX tree loaded over it. Same
    tolerance as the default path: the plain K6/K7 versions sum the same
    fp32 products in another order."""
    jv_cfg, jd_cfg = JVAEConfig(**VAE_KW), JDiTConfig(**QDIT_KW)
    vae_p = random_params(lambda k: init_vae_params(k, jv_cfg,
                                                    dtype=jnp.float32), 2)
    dit_p = random_params(lambda k: init_dit_params(k, jd_cfg,
                                                    dtype=jnp.float32), 4)
    jquant, tquant, cls = {
        "q8": (quantize_dit_params, quantize_dit_q8, Q8Linear),
        "q4": (quantize_dit_params_affine4, quantize_dit_affine4,
               AffineLinear)}[quant]
    qdit_p = jquant(dit_p, min_dim=Q_MIN_DIM)
    j_runner = JRunner(qdit_p, jd_cfg, JVAE(vae_p, jv_cfg, dtype=jnp.float32),
                       JRunnerConfig(dit=jd_cfg, vae=jv_cfg),
                       compute_dtype=jnp.float32)
    tv_cfg, td_cfg = tc.VAEConfig(**VAE_KW), tc.DiTConfig(**QDIT_KW)
    vae = VideoAutoencoder(tv_cfg, dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
    dit = NaDiT(td_cfg, dtype=torch.float32)
    dit.load_state_dict(state_dict_from_jax(dit_p), strict=True)
    dit = tquant(dit, Q_MIN_DIM)
    dit.load_state_dict(state_dict_from_jax(qdit_p), strict=True)
    assert isinstance(dit.blocks[0].attn.proj_qkv["vid"], cls)
    assert isinstance(dit.blocks[0].mlp["vid"].proj_out, cls)
    t_runner = TRunner(dit, TVAE(vae, torch.float32),
                       tc.RunnerConfig(dit=td_cfg, vae=tv_cfg),
                       compute_dtype=torch.float32)
    rng = np.random.default_rng(6)
    images = rng.uniform(0, 1, (5, 24, 20, 3)).astype(np.float32)
    emb = {"pos": rng.standard_normal((7, 32)).astype(np.float32),
           "neg": rng.standard_normal((9, 32)).astype(np.float32)}
    noise = [rng.standard_normal((2, 6, 4, 4)).astype(np.float32)]
    ref = _jax_pipeline(j_runner, images, emb, noise, "none", 0)
    out, _ = cli.process_frames(
        t_runner, images, emb, resolution=32, seed=1, batch_size=5,
        color_correction="none", noise_override=noise)
    assert out.shape == ref.shape == (5, 38, 32, 3)
    assert np.abs(out - ref).max() < 1e-4


def test_phase_ranges_attribute_events_to_phases():
    """Each pipeline phase runs inside its profiler range, and
    profile_requests' phase_breakdown gives every event that starts inside
    a range to that phase: here a CPU op stands for a phase's kernels."""
    from seedvr2_tpu_torch import profile_requests as pr

    ctx = tp.setup_generation_context("cpu")
    a = torch.ones(8, 8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tp._phase(ctx, "encode"):
            torch.mm(a, a)
        with tp._phase(ctx, "dit"):
            torch.mm(a, a)
            torch.mm(a, a)
            torch.addmm(a, a, a)
        torch.mm(a, a)  # outside every phase
    assert set(ctx["timings"]) == {"encode", "dit"}
    by_phase = pr.phase_breakdown(
        prof.events(), lambda e: float(e.key in ("aten::mm", "aten::addmm")))
    assert by_phase == {"encode": {"aten::mm": 1.0},
                        "dit": {"aten::mm": 2.0, "aten::addmm": 1.0}}
