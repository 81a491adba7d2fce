"""Command-line entry of the PyTorch port: upscale .npy frames.

    python -m seedvr2_tpu_torch.cli in.npy --output out.npy --resolution 720 \\
        --seed 42 [--dit_model dit.{safetensors,pth,gguf} \\
        --vae_model vae.safetensors] [--preset throughput] \\
        [--quant none|q8|q4|q4k|w8a8] [--vae_quant none|int8]

Input and output are float32 .npy arrays of frames (T, H, W, 3) in [0, 1]
(a single (H, W, 3) image is taken as one frame). With no checkpoint given,
the models are built with random weights on the device from --seed (the 3B
DiT). Runs the JAX package's inference_cli.py paths with the 3B or the 7B
DiT (the family comes from the checkpoint): the default (bf16 DiT, VAE_V3
untiled), `--preset throughput` (w8a8 DiT, uniform tiled VAE) and the
quantised-checkpoint lanes `--quant q8 / q4 / q4k` (core/loader.py), and
the VAE's opt-in lanes: `--vae_quant int8` (int8 decoder resnet convs) and
SEEDVR2_FUSED_NORM=1 in the environment (fused norm + SiLU + causal head),
alone or with the flags above; one step at cfg 1.0, lab colour correction.
The VAE's lowering switches SEEDVR2_UPSAMPLE_CONVT, SEEDVR2_HEAD_CORRECTION
and SEEDVR2_CONV_IM2COL are read from the environment as in the JAX
package, once, when the VAE is built.
"""

import argparse
import os
import sys
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .core import pipeline
from .core.configs import DIT_3B, VAE_V3, DiTConfig, RunnerConfig
from .core.loader import (QUANT_MODES, load_dit_checkpoint,
                          load_vae_checkpoint, quantize_dit)
from .core.runner import VAETiling, VideoDiffusionRunner
from .models.dit.nadit import init_dit
from .models.vae.pipeline_vae import VideoVAE, init_vae_params
from .utils.text_embeds import load_text_embeddings


# --preset throughput: the JAX CLI's serving bundle (inference_cli.py), applied
# only to flags left at their defaults
THROUGHPUT_PRESET = dict(
    quant="w8a8", tile_mode="uniform",
    vae_encode_tiled=True, vae_decode_tiled=True,
    vae_encode_tile_size=1536, vae_decode_tile_size=1088,
    vae_encode_tile_overlap=32, vae_decode_tile_overlap=48)


def make_runner(device, seed: int = 42, dit_model: str = None,
                vae_model: str = None, quant: str = "none",
                tiling: VAETiling = VAETiling(),
                vae_quant: str = "none",
                dit_cfg: Optional[DiTConfig] = None) -> VideoDiffusionRunner:
    """DiT + VAE_V3 in bf16 on `device`: from reference-layout checkpoints
    when given (DiT .safetensors, .pth or .gguf of the 3B or 7B family, VAE
    .safetensors, through core/loader.py, which sniffs their architecture;
    a missing file raises), else random weights drawn on the device from
    `seed`, the DiT of `dit_cfg` (DIT_7B for the 7B; the 3B when None; used
    only without `dit_model`). `quant` is the DiT's serving quantization
    (core/loader.py's table; random weights convert as a float checkpoint
    does); `vae_quant` "int8" serves the VAE decoder's resnet convs in
    int8, for a random or a loaded VAE."""
    device = torch.device(device)
    dtype = torch.bfloat16
    gen = torch.Generator(device).manual_seed(seed)
    if dit_model:
        dit = load_dit_checkpoint(dit_model, device, dtype, quant=quant)
    else:
        dit = quantize_dit(init_dit(dit_cfg or DIT_3B, device, dtype,
                                    generator=gen), quant)
    if vae_model:
        vae = load_vae_checkpoint(vae_model, device, dtype,
                                  vae_quant=vae_quant)
    else:
        vae = init_vae_params(replace(VAE_V3, conv_quant=vae_quant), device,
                              dtype, generator=gen)
    return VideoDiffusionRunner(dit, VideoVAE(vae, dtype),
                                RunnerConfig(dit=dit.cfg, vae=vae.cfg),
                                compute_dtype=dtype, tiling=tiling)


def process_frames(runner: VideoDiffusionRunner, frames: np.ndarray,
                   text_embeds, resolution: int = 1080, seed: int = 42,
                   batch_size: int = 5, temporal_overlap: int = 0,
                   max_resolution: int = 0, color_correction: str = "lab",
                   prepend_frames: int = 0, noise_override=None):
    """Run the 4 phases over one in-memory frame block (T, H, W, 3) in
    [0, 1], with the runner's VAE tiling. Returns (frames out (T, H', W', 3)
    in [0, 1], per-phase wall seconds)."""
    if prepend_frames > 0:
        frames = pipeline.pad_video_temporal(frames, count=prepend_frames,
                                             prepend=True)
    ctx = pipeline.setup_generation_context(runner.device)
    ctx["text_embeds"] = text_embeds
    ctx = pipeline.encode_all_batches(
        runner, ctx, frames, batch_size=batch_size,
        temporal_overlap=temporal_overlap, resolution=resolution,
        max_resolution=max_resolution)
    ctx = pipeline.upscale_all_batches(runner, ctx, seed=seed,
                                       noise_override=noise_override)
    ctx = pipeline.decode_all_batches(runner, ctx)
    ctx = pipeline.postprocess_all_batches(
        ctx, color_correction=color_correction, prepend_frames=prepend_frames)
    return ctx["final_video"], ctx["timings"]


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("input", help=".npy frames (T, H, W, 3) in [0, 1]")
    p.add_argument("--output", default=None,
                   help="output .npy (default: <input>_upscaled.npy)")
    p.add_argument("--dit_model", default=None,
                   help="reference-layout 3B or 7B DiT: .safetensors (fp16, "
                        "bf16, fp32, fp8 or the 7B fp8-mixed file), .pth / "
                        ".pt, or .gguf")
    p.add_argument("--vae_model", default=None,
                   help="reference-layout VAE .safetensors")
    p.add_argument("--model_dir", default=None,
                   help="directory searched first for {pos,neg}_emb")
    p.add_argument("--resolution", type=int, default=1080)
    p.add_argument("--max_resolution", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--temporal_overlap", type=int, default=0)
    p.add_argument("--prepend_frames", type=int, default=0)
    p.add_argument("--color_correction", default="lab",
                   choices=("lab", "none"))
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda requires a visible GPU")
    p.add_argument("--preset", default=None, choices=("throughput",),
                   help="flag bundle, explicit flags win: w8a8 DiT, uniform "
                        "tiled VAE with 1536 px encode / 1088 px decode "
                        "tiles at 32 / 48 px overlap")
    p.add_argument("--quant", default="none", choices=QUANT_MODES,
                   help="DiT serving quantization: q8 = Q8_0 int8 weights "
                        "with per-32 scales through a dequantizing GEMM "
                        "(GGUF files keep their Q8_0 blocks); q4k = GGUF "
                        "Q4_K/Q5_K served in their native affine layout "
                        "(float files: as q8); q4 = post-training 4-bit "
                        "affine quantization of a float checkpoint (same "
                        "kernel as q4k; stored one int8 per quant, 1.25 "
                        "B/weight); w8a8 = per-channel int8 weights, "
                        "per-row int8 activations")
    p.add_argument("--vae_quant", default="none", choices=("none", "int8"),
                   help="int8: the VAE decoder's 3x3x3 resnet convs run as "
                        "int8 convs (per-frame activation scale, "
                        "per-channel weight scales) through a hand-written "
                        "kernel; experimental, its speed is in PERF.md. "
                        "--preset throughput does not set it")
    p.add_argument("--vae_encode_tiled", action="store_true")
    p.add_argument("--vae_encode_tile_size", type=int, default=1024)
    p.add_argument("--vae_encode_tile_overlap", type=int, default=128)
    p.add_argument("--vae_decode_tiled", action="store_true")
    p.add_argument("--vae_decode_tile_size", type=int, default=1024)
    p.add_argument("--vae_decode_tile_overlap", type=int, default=128)
    p.add_argument("--tile_mode", default="uniform", choices=("uniform",),
                   help="uniform = even same-shape tile grid")
    args = p.parse_args(argv)
    if args.preset == "throughput":
        for name, val in THROUGHPUT_PRESET.items():
            if getattr(args, name) == p.get_default(name):
                setattr(args, name, val)
    return args


def tiling_from_args(args) -> VAETiling:
    return VAETiling(
        encode_tiled=args.vae_encode_tiled,
        encode_tile_size=(args.vae_encode_tile_size,) * 2,
        encode_tile_overlap=(args.vae_encode_tile_overlap,) * 2,
        decode_tiled=args.vae_decode_tiled,
        decode_tile_size=(args.vae_decode_tile_size,) * 2,
        decode_tile_overlap=(args.vae_decode_tile_overlap,) * 2,
        tile_mode=args.tile_mode)


def main(argv=None) -> str:
    args = parse_arguments(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is visible")
    frames = np.load(args.input).astype(np.float32)
    if frames.ndim == 3:
        frames = frames[None]
    runner = make_runner(device, args.seed, args.dit_model, args.vae_model,
                         quant=args.quant, tiling=tiling_from_args(args),
                         vae_quant=args.vae_quant)
    embeds = load_text_embeddings([args.model_dir] if args.model_dir else (),
                                  txt_dim=runner.dit_cfg.txt_in_dim)
    out, timings = process_frames(
        runner, frames, embeds, resolution=args.resolution, seed=args.seed,
        batch_size=args.batch_size, temporal_overlap=args.temporal_overlap,
        max_resolution=args.max_resolution,
        color_correction=args.color_correction,
        prepend_frames=args.prepend_frames)
    out_path = args.output or os.path.splitext(args.input)[0] + "_upscaled.npy"
    np.save(out_path, out)
    print(f"wrote {out_path} {out.shape}; phase seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()),
          file=sys.stderr)
    return out_path


if __name__ == "__main__":
    main()
