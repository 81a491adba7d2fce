"""Command-line entry of the PyTorch port: upscale .npy frames.

    python -m seedvr2_tpu_torch.cli in.npy --output out.npy --resolution 720 \\
        --seed 42 [--dit_model dit.{safetensors,pth,gguf} \\
        --vae_model vae.safetensors] [--preset throughput] \\
        [--quant none|q8|q4|q4k|w8a8] [--vae_quant none|int8] \\
        [--color_correction lab|wavelet|wavelet_adaptive|hsv|adain|none] \\
        [--input_noise_scale S] [--latent_noise_scale S] \\
        [--uniform_batch_size] [--tile_mode uniform|ref] \\
        [--tile_debug false|encode|decode] \\
        [--vae_encode_tile_size N|auto] [--vae_decode_tile_size N|auto] \
        [--model_dir DIR] [--blocks_to_swap N] [--cache_dit] [--cache_vae]

Input and output are float32 .npy arrays of frames (T, H, W, 3) in [0, 1],
or (T, H, W, 4) RGBA, whose alpha is upscaled edge-guided and comes out as
the fourth channel (a single (H, W, C) image is taken as one frame). With
no checkpoint given, the models are built with random weights on the
device from --seed (the 3B DiT). Runs the JAX package's inference_cli.py
paths with the 3B or the 7B DiT (the family comes from the checkpoint):
the default (bf16 DiT, VAE_V3 untiled), `--preset throughput` (w8a8 DiT,
uniform tiled VAE) and the quantised-checkpoint lanes `--quant q8 / q4 /
q4k` (core/loader.py), and the VAE's opt-in lanes: `--vae_quant int8`
(int8 decoder resnet convs) and SEEDVR2_FUSED_NORM=1 in the environment
(fused norm + SiLU + causal head), alone or with the flags above; one step
at cfg 1.0, lab colour correction by default.
The VAE's lowering switches SEEDVR2_UPSAMPLE_CONVT, SEEDVR2_HEAD_CORRECTION
and SEEDVR2_CONV_IM2COL are read from the environment as in the JAX
package, once, when the VAE is built. A tile size of `auto` picks the
fewest-tiles grid that fits the card from memory probes run on it, cached
in ~/.cache/seedvr2_tpu_torch/memprobe.json (or $SEEDVR2_MEMPROBE_CACHE).
--vae_model also takes the legacy video_vae.py layout (sniffed).
Checkpoint names are searched through utils/constants.find_model_path
($SEEDVR2_MODEL_PATHS, --model_dir, the ComfyUI roots). The runner comes
from core/model_manager.configure_runner, which keeps the DiT on the card,
offloads it to pinned host memory through the VAE phases, or streams its
blocks from there (--blocks_to_swap N forces the last N to stream; by
default the card's memory decides); --swap_io_components is accepted and
does nothing, as in JAX.
"""

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from .core import pipeline
from .core.configs import DIT_3B, VAE_V3, DiTConfig
from .core.loader import QUANT_MODES
from .core.model_manager import configure_runner
from .core.runner import VAETiling, VideoDiffusionRunner
from .models.vae.pipeline_vae import TILE_MODES
from .utils import color_fix
from .utils.text_embeds import load_text_embeddings


# --preset throughput: the JAX CLI's serving bundle (inference_cli.py), applied
# only to flags left at their defaults
THROUGHPUT_PRESET = dict(
    quant="w8a8", tile_mode="uniform",
    vae_encode_tiled=True, vae_decode_tiled=True,
    vae_encode_tile_size=1536, vae_decode_tile_size=1088,
    vae_encode_tile_overlap=32, vae_decode_tile_overlap=48)


def _tile_size(v: str):
    """Argparse type of the tile-size flags: an int px side, or "auto" for
    the memory-probed plan (utils/memplan.py)."""
    if v.strip().lower() == "auto":
        return "auto"
    return int(v)


def make_runner(device, seed: int = 42, dit_model: str = None,
                vae_model: str = None, quant: str = "none",
                tiling: VAETiling = VAETiling(),
                vae_quant: str = "none",
                dit_cfg: Optional[DiTConfig] = None,
                model_dir: Optional[str] = None, blocks_to_swap: int = 0,
                dit_cache: bool = False,
                vae_cache: bool = False) -> VideoDiffusionRunner:
    """DiT + VAE_V3 in bf16 on `device`, through
    core.model_manager.configure_runner: from reference-layout checkpoints
    when given (DiT .safetensors, .pth or .gguf of the 3B or 7B family, VAE
    .safetensors, through core/loader.py, which sniffs their architecture;
    a name is searched in `model_dir` and the other model paths, and a
    missing file raises), else random weights drawn on the device from
    `seed`, the DiT of `dit_cfg` (DIT_7B for the 7B; the 3B when None; used
    only without `dit_model`). `quant` is the DiT's serving quantization
    (core/loader.py's table; random weights convert as a float checkpoint
    does); `vae_quant` "int8" serves the VAE decoder's resnet convs in
    int8, for a random or a loaded VAE. blocks_to_swap > 0 streams the
    last N DiT blocks from pinned host memory (0: decided by the card's
    memory); dit_cache / vae_cache keep the models across calls."""
    return configure_runner(
        dit_model, vae_model, base_cache_dir=model_dir, dit_cache=dit_cache,
        vae_cache=vae_cache,
        block_swap_config={"blocks_to_swap": blocks_to_swap}, tiling=tiling,
        quant=quant, vae_quant=vae_quant, device=device, seed=seed,
        dit_cfg=dit_cfg or DIT_3B, vae_cfg=VAE_V3)


def process_frames(runner: VideoDiffusionRunner, frames: np.ndarray,
                   text_embeds, resolution: int = 1080, seed: int = 42,
                   batch_size: int = 5, temporal_overlap: int = 0,
                   max_resolution: int = 0, color_correction: str = "lab",
                   prepend_frames: int = 0, noise_override=None,
                   uniform_batch_size: bool = False,
                   input_noise_scale: float = 0.0,
                   latent_noise_scale: float = 0.0,
                   tile_debug: str = "false"):
    """Run the 4 phases over one in-memory frame block (T, H, W, 3 or 4) in
    [0, 1], with the runner's VAE tiling. Returns (frames out (T, H', W',
    3 or 4) in [0, 1], per-phase wall seconds)."""
    if prepend_frames > 0:
        frames = pipeline.pad_video_temporal(frames, count=prepend_frames,
                                             prepend=True)
    ctx = pipeline.setup_generation_context(runner.device,
                                            tile_debug=tile_debug)
    ctx["text_embeds"] = text_embeds
    ctx = pipeline.encode_all_batches(
        runner, ctx, frames, batch_size=batch_size,
        uniform_batch_size=uniform_batch_size, seed=seed,
        temporal_overlap=temporal_overlap, resolution=resolution,
        max_resolution=max_resolution, input_noise_scale=input_noise_scale)
    ctx = pipeline.upscale_all_batches(runner, ctx, seed=seed,
                                       latent_noise_scale=latent_noise_scale,
                                       noise_override=noise_override)
    ctx = pipeline.decode_all_batches(runner, ctx)
    ctx = pipeline.postprocess_all_batches(
        ctx, color_correction=color_correction, prepend_frames=prepend_frames)
    return ctx["final_video"], ctx["timings"]


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("input", help=".npy frames (T, H, W, 3) in [0, 1], or "
                                 "(T, H, W, 4) RGBA")
    p.add_argument("--output", default=None,
                   help="output .npy (default: <input>_upscaled.npy)")
    p.add_argument("--dit_model", default=None,
                   help="reference-layout 3B or 7B DiT: .safetensors (fp16, "
                        "bf16, fp32, fp8 or the 7B fp8-mixed file), .pth / "
                        ".pt, or .gguf")
    p.add_argument("--vae_model", default=None,
                   help="reference-layout VAE .safetensors (the VAE_V3 or "
                        "the legacy video_vae.py layout)")
    p.add_argument("--model_dir", default="./models",
                   help="directory searched for the checkpoints (after "
                        "$SEEDVR2_MODEL_PATHS) and first for {pos,neg}_emb")
    p.add_argument("--resolution", type=int, default=1080)
    p.add_argument("--max_resolution", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=5)
    p.add_argument("--uniform_batch_size", action="store_true",
                   help="pad a short trailing batch to --batch_size frames")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--temporal_overlap", type=int, default=0)
    p.add_argument("--prepend_frames", type=int, default=0)
    p.add_argument("--color_correction", default="lab",
                   choices=color_fix.METHODS)
    p.add_argument("--input_noise_scale", type=float, default=0.0,
                   help="blend N(0, 0.05) noise into the input with weight "
                        "scale / 2 before encoding")
    p.add_argument("--latent_noise_scale", type=float, default=0.0,
                   help="move the condition latent to the shifted timestep "
                        "1000 * scale before the DiT")
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
    p.add_argument("--vae_encode_tile_size", type=_tile_size, default=1024,
                   help="tile side in px, or 'auto': the fewest-tiles grid "
                        "that fits the card, from memory probes run on it")
    p.add_argument("--vae_encode_tile_overlap", type=int, default=128)
    p.add_argument("--vae_decode_tiled", action="store_true")
    p.add_argument("--vae_decode_tile_size", type=_tile_size, default=1024,
                   help="tile side in px, or 'auto' (see encode)")
    p.add_argument("--vae_decode_tile_overlap", type=int, default=128)
    p.add_argument("--tile_debug", default="false",
                   choices=pipeline.TILE_DEBUG,
                   help="draw the last tiled encode's or decode's tile "
                        "outlines over the output")
    p.add_argument("--tile_mode", default="uniform", choices=TILE_MODES,
                   help="uniform = even same-shape tile grid; ref = the "
                        "reference's stride-sweep layout")
    p.add_argument("--blocks_to_swap", type=int, default=0,
                   help="stream the last N transformer blocks from host "
                        "RAM (auto-engages for larger-than-HBM models)")
    p.add_argument("--swap_io_components", action="store_true",
                   help="accepted for API compat (IO params always stay "
                        "in HBM; they are <1%% of the model)")
    p.add_argument("--cache_dit", action="store_true")
    p.add_argument("--cache_vae", action="store_true")
    args = p.parse_args(argv)
    if args.preset == "throughput":
        for name, val in THROUGHPUT_PRESET.items():
            if getattr(args, name) == p.get_default(name):
                setattr(args, name, val)
    return args


def tiling_from_args(args) -> VAETiling:
    def size(v):
        return "auto" if v == "auto" else (v, v)

    return VAETiling(
        encode_tiled=args.vae_encode_tiled,
        encode_tile_size=size(args.vae_encode_tile_size),
        encode_tile_overlap=(args.vae_encode_tile_overlap,) * 2,
        decode_tiled=args.vae_decode_tiled,
        decode_tile_size=size(args.vae_decode_tile_size),
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
                         vae_quant=args.vae_quant, model_dir=args.model_dir,
                         blocks_to_swap=args.blocks_to_swap,
                         dit_cache=args.cache_dit, vae_cache=args.cache_vae)
    # the model dir, then this package's directory (the JAX CLI's own
    # directory), then the packaged embeddings
    embeds = load_text_embeddings(
        [args.model_dir, os.path.dirname(os.path.abspath(__file__))],
        txt_dim=runner.dit_cfg.txt_in_dim)
    out, timings = process_frames(
        runner, frames, embeds, resolution=args.resolution, seed=args.seed,
        batch_size=args.batch_size, temporal_overlap=args.temporal_overlap,
        max_resolution=args.max_resolution,
        color_correction=args.color_correction,
        prepend_frames=args.prepend_frames,
        uniform_batch_size=args.uniform_batch_size,
        input_noise_scale=args.input_noise_scale,
        latent_noise_scale=args.latent_noise_scale,
        tile_debug=args.tile_debug)
    out_path = args.output or os.path.splitext(args.input)[0] + "_upscaled.npy"
    np.save(out_path, out)
    print(f"wrote {out_path} {out.shape}; phase seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()),
          file=sys.stderr)
    if runner.streamed_dit is not None:
        stats = runner.streamed_dit.stats
        print(f"BlockSwap (keep {runner.streamed_dit.keep_blocks}/"
              f"{runner.dit_cfg.num_layers} blocks on the card): "
              f"{stats.summary()} {stats.transfer()}", file=sys.stderr)
    return out_path


if __name__ == "__main__":
    main()
