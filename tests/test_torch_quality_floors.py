"""The port's quantised serving lanes held to their whole-pipeline PSNR
floors (docs/parity.md) against the JAX package's fp32 four-phase
pipeline, on the CPU.

The yardstick is the configuration of tests/test_pipeline_oracle.py's
`qoracle`: the 3B layout at vid_dim 32, head_dim 16 (32-aligned, so that
Q8_0 and the affine groups quantize), the tiny VAE (8, 8, 16, 16) with 4
latent channels, frames (5, 20, 28, 3) and text from default_rng(11), 32
px, one batch of 5, wavelet colour. Its weights are seeded numpy values in
the JAX init's shapes (the reference's torch init, which the oracle test
uses, needs the reference sources). The JAX pipeline runs once per module
in fp32 with one injected noise drawn with numpy; the port serves the same
weights through its own conversions (min_dim 32, align 32) and its own
pipeline with that noise:

 - q8 (Q8_0 linears, K6's plain version) >= 70 dB,
 - w8a8 (per-channel int8 weights, per-token int8 rows: K3-K5's) >= 69 dB,
 - q4 (4-bit affine, K7's) >= 44 dB

(docs/parity.md:65-69: measured 76.7 / 75.7 / 50.6 dB there). The q4k
lane serves a GGUF file the test writes, laid out as
tests/test_torch_loader.py's gguf_file (Q8_0 attention linears, Q4_K gate /
up and Q5_K MLP out, F16 dense linears, F32 vectors), through
load_dit_checkpoint(quant="q4k"): Q8_0 as K6's layout, Q4_K / Q5_K as K7's
affine groups as stored. It is held to >= 70 dB against the JAX fp32
pipeline on the same file's dequantized weights (docs/parity.md:78-82:
q4k adds no quantization of its own). Native K-quant serving needs both
dims of a linear >= 1024 and K a multiple of 256 (core/loader.py), so this
file's DiT is the same layout at vid_dim 1024, 8 heads of 128. Each
conversion must have quantized at least 4 linears, or its floor would say
nothing. Each test prints its PSNR (pytest -s)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seedvr2_tpu.core import model_manager as jmm
from seedvr2_tpu.core import pipeline as jp
from seedvr2_tpu.core.configs import DiTConfig as JDiTConfig
from seedvr2_tpu.core.configs import RunnerConfig as JRunnerConfig
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core import export as jexport
from seedvr2_tpu.core.runner import VideoDiffusionRunner as JRunner
from seedvr2_tpu.models.dit.nadit import init_dit_params
from seedvr2_tpu.models.vae.pipeline_vae import VideoVAE as JVAE
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu_torch import cli
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core import loader as tl
from seedvr2_tpu_torch.core.runner import VideoDiffusionRunner as TRunner
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit.nadit import NaDiT
from seedvr2_tpu_torch.models.vae.model import VideoAutoencoder
from seedvr2_tpu_torch.models.vae.pipeline_vae import VideoVAE as TVAE
from seedvr2_tpu_torch.ops import gguf as tg
from seedvr2_tpu_torch.ops.int8_matmul import W8A8Linear
from seedvr2_tpu_torch.ops.quant_matmul import AffineLinear, Q8Linear

from .test_torch_dit import random_params
from .test_torch_gguf import write_gguf
from .test_torch_loader import _kquant_bytes, _q8_0_bytes

# docs/parity.md:65-69 and :78-82
PSNR_FLOORS_DB = {"q8": 70.0, "w8a8": 69.0, "q4": 44.0, "q4k": 70.0}
MIN_DIM = ALIGN = 32
DIT_KW = dict(family="dit_3b", vid_in_channels=9, vid_out_channels=4,
              vid_dim=32, txt_in_dim=16, heads=2, head_dim=16, expand_ratio=4,
              norm_eps=1e-5, qk_bias=False, patch_size=(1, 2, 2),
              num_layers=2, mm_layers=1, mlp_type="swiglu", window=(2, 2, 2),
              rope_type="mmrope3d", rope_dim=16, vid_out_norm=True)
Q4K_KW = dict(DIT_KW, vid_dim=1024, heads=8, head_dim=128, rope_dim=128)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
              latent_channels=4, norm_num_groups=4)
REQUEST = dict(batch_size=5, temporal_overlap=0, resolution=32,
               color_correction="wavelet")
SEED = 42
QUANTISED = (W8A8Linear, Q8Linear, AffineLinear)


def _psnr(a, b):
    rmse = np.sqrt(np.mean((a - b) ** 2))
    return 20 * np.log10(1.0 / max(rmse, 1e-12))


def _jax_pipeline(dit_params, dit_cfg, vae, frames, text, noise):
    """JAX's fp32 four phases (tests/test_pipeline_oracle.py's _run_ours)
    with the given per-batch noise, or with the one that noise(shape)
    draws for the first latent's shape; returns the frames and the noise."""
    runner = JRunner(dit_params, dit_cfg, vae,
                     JRunnerConfig(dit=dit_cfg, vae=vae.cfg),
                     compute_dtype=jnp.float32, attention_mode="xla")
    ctx = jp.setup_generation_context()
    ctx["text_embeds"] = {"pos": jnp.asarray(text), "neg": jnp.asarray(text)}
    ctx = jp.encode_all_batches(runner, ctx, frames, seed=SEED, **REQUEST)
    if callable(noise):
        noise = noise(ctx["all_latents"][0].shape)
    ctx = jp.upscale_all_batches(runner, ctx, seed=SEED, noise_override=noise)
    ctx = jp.decode_all_batches(runner, ctx)
    ctx = jp.postprocess_all_batches(
        ctx, color_correction=REQUEST["color_correction"],
        temporal_overlap=0, batch_size=REQUEST["batch_size"])
    return np.asarray(ctx["final_video"], np.float32), noise


def _port_vae(vae_params):
    vae = VideoAutoencoder(tc.VAEConfig(**VAE_KW), dtype=torch.float32)
    vae.load_state_dict(state_dict_from_jax(vae_params), strict=True)
    return TVAE(vae, torch.float32)


def _port_pipeline(dit, vae, frames, text, noise):
    runner = TRunner(dit, vae, tc.RunnerConfig(dit=dit.cfg, vae=vae.cfg),
                     compute_dtype=torch.float32)
    out, _ = cli.process_frames(runner, frames, {"pos": text, "neg": text},
                                seed=SEED, noise_override=noise, **REQUEST)
    return out


@pytest.fixture(scope="module")
def qoracle():
    """The JAX fp32 pipeline's output on the qoracle config, its inputs,
    weights and noise (drawn after the frames from the same stream)."""
    rng = np.random.default_rng(11)
    text = (rng.standard_normal((7, 16)) * 0.2).astype(np.float32)
    frames = np.clip(0.5 + 0.25 * rng.standard_normal((5, 20, 28, 3)),
                     0.0, 1.0).astype(np.float32)
    dit_cfg, vae_cfg = JDiTConfig(**DIT_KW), JVAEConfig(**VAE_KW)
    dit_p = random_params(lambda k: init_dit_params(
        k, dit_cfg, dtype=jnp.float32), 0)
    vae_p = random_params(lambda k: init_vae_params(
        k, vae_cfg, dtype=jnp.float32), 3)
    jvae = JVAE(vae_p, vae_cfg, dtype=jnp.float32)
    ref, noise = _jax_pipeline(
        dit_p, dit_cfg, jvae, frames, text,
        lambda shape: [rng.standard_normal(shape).astype(np.float32)])
    return dict(dit_p=dit_p, vae_p=vae_p, jvae=jvae, text=text,
                frames=frames, ref=ref, noise=noise)


def _converted(model):
    return sum(isinstance(m, QUANTISED) for m in model.modules())


@pytest.mark.parametrize("lane", ["q8", "w8a8", "q4"])
def test_quantised_lane_psnr_floor(qoracle, lane):
    dit = NaDiT(tc.DiTConfig(**DIT_KW), dtype=torch.float32)
    dit.load_state_dict(state_dict_from_jax(qoracle["dit_p"]), strict=True)
    tl.quantize_dit(dit, lane, False, MIN_DIM, ALIGN)
    n = _converted(dit)
    assert n >= 4, f"{lane}: the conversion quantized only {n} linears"
    out = _port_pipeline(dit, _port_vae(qoracle["vae_p"]), qoracle["frames"],
                         qoracle["text"], qoracle["noise"])
    assert out.shape == qoracle["ref"].shape == (5, 32, 44, 3)
    psnr = _psnr(qoracle["ref"], out)
    print(f"{lane}: {psnr:.1f} dB over {n} quantised linears")
    assert psnr >= PSNR_FLOORS_DB[lane], (
        f"--quant {lane} whole-pipeline PSNR against JAX's fp32 pipeline: "
        f"{psnr:.1f} dB < {PSNR_FLOORS_DB[lane]} dB")


def _write_q4k_gguf(path):
    """A Q4_K_M-like file of the Q4K_KW DiT: Q8_0 attention linears (block
    0's video qkv kept F32 so the config sniff reads it), Q4_K gate / up,
    Q5_K MLP out, F16 other linears, F32 vectors."""
    params = random_params(lambda k: init_dit_params(
        k, JDiTConfig(**Q4K_KW), dtype=jnp.float32), 12)
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    tensors = []
    for i, (name, v) in enumerate(sorted(state.items())):
        if name == "blocks.0.attn.proj_qkv.vid.weight" or v.ndim == 1:
            qt, raw = tg.F32, v.tobytes()
        elif ".attn.proj_" in name:
            qt, raw = tg.Q8_0, _q8_0_bytes(v)
        elif ".mlp." in name:
            qt = tg.Q5_K if "proj_out" in name else tg.Q4_K
            raw = _kquant_bytes(qt, v.shape, i)
        else:
            qt, raw = tg.F16, v.astype(np.float16).tobytes()
        tensors.append(("model.diffusion_model." + name, v.shape, qt, raw,
                        None))
    write_gguf(path, tensors)


def test_q4k_gguf_lane_psnr_floor(qoracle, tmp_path):
    path = str(tmp_path / "seedvr2_tiny-Q4_K_M.gguf")
    _write_q4k_gguf(path)
    jparams, jcfg = jmm.load_dit_checkpoint(path, dtype=jnp.float32)
    dit = tl.load_dit_checkpoint(path, "cpu", torch.float32, quant="q4k")
    assert dit.cfg.vid_dim == jcfg.vid_dim == 1024
    kinds = [type(m) for m in dit.modules() if isinstance(m, QUANTISED)]
    assert len(kinds) >= 4 and set(kinds) == {Q8Linear, AffineLinear}
    ref, _ = _jax_pipeline(jparams, jcfg, qoracle["jvae"], qoracle["frames"],
                           qoracle["text"], qoracle["noise"])
    out = _port_pipeline(dit, _port_vae(qoracle["vae_p"]), qoracle["frames"],
                         qoracle["text"], qoracle["noise"])
    assert out.shape == ref.shape
    psnr = _psnr(ref, out)
    print(f"q4k: {psnr:.1f} dB over {len(kinds)} quantised linears")
    assert psnr >= PSNR_FLOORS_DB["q4k"], (
        f"--quant q4k (GGUF) whole-pipeline PSNR against JAX's fp32 "
        f"pipeline on the dequantized file: {psnr:.1f} dB < "
        f"{PSNR_FLOORS_DB['q4k']} dB")
