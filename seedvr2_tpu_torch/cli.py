"""Command-line entry of the PyTorch port: upscale .npy frames.

    python -m seedvr2_tpu_torch.cli in.npy --output out.npy --resolution 720 \\
        --seed 42 [--dit_model dit.safetensors --vae_model vae.safetensors] \\
        [--preset throughput]

Input and output are float32 .npy arrays of frames (T, H, W, 3) in [0, 1]
(a single (H, W, 3) image is taken as one frame). With no checkpoint given,
the models are built with random weights on the device from --seed. Runs the
JAX package's inference_cli.py paths: the default (3B DiT in bf16, VAE_V3
untiled) and `--preset throughput` (w8a8 DiT, uniform tiled VAE), one step
at cfg 1.0, lab colour correction.
"""

import argparse
import os
import sys

import numpy as np
import torch

from .core import pipeline
from .core.configs import DIT_3B, VAE_V3, RunnerConfig
from .core.runner import VAETiling, VideoDiffusionRunner
from .core.weights import load_safetensors_checkpoint
from .models.dit.nadit import NaDiT, init_dit
from .models.vae.model import VideoAutoencoder
from .models.vae.pipeline_vae import VideoVAE, init_vae_params
from .ops.int8_matmul import quantize_dit_w8a8
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
                tiling: VAETiling = VAETiling()) -> VideoDiffusionRunner:
    """3B DiT + VAE_V3 in bf16 on `device`: from reference-layout
    safetensors checkpoints when given, else random weights drawn on the
    device from `seed`. quant="w8a8" converts the DiT's large linears to
    int8 (ops.int8_matmul.quantize_dit_w8a8) after loading."""
    if quant not in ("none", "w8a8"):
        raise ValueError(f"quant={quant!r}: only none and w8a8 are ported")
    device = torch.device(device)
    dit_cfg, vae_cfg, dtype = DIT_3B, VAE_V3, torch.bfloat16
    gen = torch.Generator(device).manual_seed(seed)
    if dit_model:
        dit = load_safetensors_checkpoint(
            dit_model, NaDiT(dit_cfg, device=device, dtype=dtype))
    else:
        dit = init_dit(dit_cfg, device, dtype, generator=gen)
    if quant == "w8a8":
        dit = quantize_dit_w8a8(dit)
    if vae_model:
        vae = load_safetensors_checkpoint(
            vae_model, VideoAutoencoder(vae_cfg, device=device, dtype=dtype))
    else:
        vae = init_vae_params(vae_cfg, device, dtype, generator=gen)
    return VideoDiffusionRunner(dit, VideoVAE(vae, dtype),
                                RunnerConfig(dit=dit_cfg, vae=vae_cfg),
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
                   help="reference-layout 3B DiT .safetensors")
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
    p.add_argument("--quant", default="none", choices=("none", "w8a8"),
                   help="DiT serving quantization: w8a8 = per-channel int8 "
                        "weights, per-row int8 activations")
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
                         quant=args.quant, tiling=tiling_from_args(args))
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
