"""Command-line entry of the PyTorch port: upscale videos, images,
directories of frames and .npy arrays.

    python -m seedvr2_tpu_torch.cli INPUT [--output PATH]
        [--output_format mp4|png] [--resolution 1080] [--seed 42]
        [--chunk_size N --temporal_overlap K] [--skip_first_frames N]
        [--load_cap N] [--dit_model NAME|random] [--vae_model NAME|random]
        [--preset quality|throughput] [--attention_mode flash|xla|sdpa|...]
        [--quant none|q8|q4|q4k|w8a8] [--vae_quant none|int8]
        [--color_correction lab|wavelet|wavelet_adaptive|hsv|adain|none]
        [--parity_check --parity_ref CAPTURE] [--debug] [--profile_dir DIR]
        [--data_parallel auto|off] [--tensor_parallel T]
        [--num_hosts N --host_index I [--coordinator_address HOST:PORT]]
        [--num_hosts N --join_parts]
    torchrun --nproc_per_node N -m seedvr2_tpu_torch.cli INPUT ...
    python -m seedvr2_tpu_torch.cli --doctor
    python -m seedvr2_tpu_torch.cli --convert_embeddings SRC_DIR DST_DIR

The surface of the JAX package's inference_cli.py, with its flags,
defaults and checks.

Parallelism: one process a card, over torch.distributed (parallel/). Under
torchrun (WORLD_SIZE in the environment) each process joins the process
group (NCCL on cards, gloo with --device cpu) and serves on card
LOCAL_RANK; with no launcher, a run on a host with more than one visible
card whose flags ask for them starts one worker a card itself (a
rendezvous on 127.0.0.1), so one command uses every local card, as the JAX
CLI's does. --tensor_parallel T shards the DiT's heads and mlp hidden over
T of them (parallel/tp.py; it must divide them: on one card T = 2 exits 2),
--data_parallel auto spreads batches over the rest (dp = cards / T; off:
only T cards). Every rank reads the input; rank 0 writes the output.
--num_hosts N fans a long video out over hosts by frame ranges, each host
writing a .npy segment (--host_index, default the rank in the hosts'
process group that --coordinator_address host:port of host 0 joins, which
only sets that default: the fan-out is file-based), and --join_parts then
Hann-blends the segments into the output, one segment in memory at a time
(parallel/multihost.py). Inside a host the mesh spans its cards as above:
the CLI starts one worker a local card and hands them the host index, or
torchrun runs per host (WORLD_SIZE its local processes) with --host_index
given.

INPUT is a video (OpenCV; streamed --chunk_size frames at a time in bounded
memory, the last --temporal_overlap input frames of a chunk fed again to
the next and the seam Hann-blended, each frame written once), an image, a
directory of images, or the port's .npy array of frames (T, H, W, 3) in
[0, 1], or (T, H, W, 4) RGBA, whose alpha is upscaled edge-guided and comes
out as the fourth channel; a single (H, W, C) array is one frame. A .npy
input streams through the same chunk loop from a memory map into a
memory-mapped .npy output (<input>_upscaled.npy unless --output /
--output_format say otherwise), so it needs no OpenCV: the way to feed a
machine without it. Video, image and directory paths need OpenCV.

Models: --dit_model / --vae_model name reference-layout checkpoints
(core/loader.py: DiT .safetensors, .pth or .gguf of the 3B or 7B family;
the VAE_V3 or the legacy VAE layout), searched through
utils/constants.find_model_path ($SEEDVR2_MODEL_PATHS, --model_dir, the
ComfyUI roots). The defaults are the JAX CLI's checkpoint names; a missing
one is downloaded into --model_dir and checked against the registry's
SHA256 (utils/downloads.py), as in JAX. The name `random` builds random
weights on the device from --seed (the 3B DiT, VAE_V3). The runner comes
from core/model_manager.configure_runner, which keeps the DiT on the card,
offloads it through the VAE phases or streams its blocks (--blocks_to_swap;
by default the card's memory decides) and caches models and runners
(--cache_dit / --cache_vae), keyed on every knob, --attention_mode among
them. --attention_mode flash (default; alias flash_attn) runs the
hand-written attention kernels, xla (alias sdpa) the SDPA lane of
ops/attention.py. `--preset throughput` is the JAX serving bundle (w8a8
DiT, uniform tiled VAE; explicit flags win), `--preset quality` the
defaults. --vae_quant int8 and SEEDVR2_FUSED_NORM=1 take the VAE's kernel
lanes; SEEDVR2_UPSAMPLE_CONVT, SEEDVR2_HEAD_CORRECTION and
SEEDVR2_CONV_IM2COL are read once when the VAE is built. On the card the
decoder's upsample runs one hand-written kernel (ops/upsample.py) whatever
SEEDVR2_UPSAMPLE_CONVT says; the switch picks only the plain form (CPU
runs). A tile size of
`auto` plans tiles from memory probes run on the card
(utils/memplan.py, cached in ~/.cache/seedvr2_tpu_torch/memprobe.json or
$SEEDVR2_MEMPROBE_CACHE).

--device auto (the default) and cuda run on the card and raise when no GPU
is visible; cpu runs the kernels' plain versions. --debug logs phases,
timers and memory checkpoints (utils/debug.py), --profile_dir writes a
torch.profiler chrome trace per phase, --parity_check scores the output
against --parity_ref (utils/parity.py, one JSON line; exit 1 below
--parity_min_psnr), --doctor prints a health report (utils/doctor.py; exit
0 when the card computed, 3 when not). --compile_dit, --compile_vae and
--swap_io_components are accepted and do nothing, as in JAX.
"""

import argparse
import os
import socket
import sys
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .core import pipeline
from .core.configs import DIT_3B, VAE_V3, DiTConfig
from .core.loader import QUANT_MODES
from .core.model_manager import configure_runner
from .core.runner import VAETiling, VideoDiffusionRunner
from .models.vae.pipeline_vae import TILE_MODES
from .parallel import multihost
from .parallel.mesh import Mesh, make_mesh, rank_device
from .utils import color_fix, spans, video_io
from .utils.debug import Debug
from .utils.model_registry import DEFAULT_DIT, DEFAULT_VAE
from .utils.text_embeds import load_text_embeddings


# --preset throughput: the JAX CLI's serving bundle (inference_cli.py), applied
# only to flags left at their defaults
THROUGHPUT_PRESET = dict(
    quant="w8a8", tile_mode="uniform",
    vae_encode_tiled=True, vae_decode_tiled=True,
    vae_encode_tile_size=1536, vae_decode_tile_size=1088,
    vae_encode_tile_overlap=32, vae_decode_tile_overlap=48)

# --dit_model / --vae_model name of random weights drawn from --seed
RANDOM_WEIGHTS = "random"


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
                dit_cache: bool = False, vae_cache: bool = False,
                attention_mode: str = "flash",
                mesh: Optional[Mesh] = None) -> VideoDiffusionRunner:
    """DiT + VAE_V3 in bf16 on `device`, through
    core.model_manager.configure_runner: from reference-layout checkpoints
    when given (DiT .safetensors, .pth or .gguf of the 3B or 7B family, VAE
    .safetensors, through core/loader.py, which sniffs their architecture;
    a name is searched in `model_dir` and the other model paths, and a
    missing one downloaded into `model_dir`, a missing path raises), else
    random weights drawn on the device from
    `seed`, the DiT of `dit_cfg` (DIT_7B for the 7B; the 3B when None; used
    only without `dit_model`). `quant` is the DiT's serving quantization
    (core/loader.py's table; random weights convert as a float checkpoint
    does); `vae_quant` "int8" serves the VAE decoder's resnet convs in
    int8, for a random or a loaded VAE. blocks_to_swap > 0 streams the
    last N DiT blocks from pinned host memory (0: decided by the card's
    memory); dit_cache / vae_cache keep the models across calls;
    attention_mode picks the kernels ("flash") or the SDPA lane ("xla").
    mesh (build_mesh): serve over it, as the JAX CLI's make_runner does:
    configure_runner plans the memory for its tp extent, then the runner
    is attached to it (every rank of the mesh makes the same call)."""
    tp = mesh.shape.get("tp", 1) if mesh is not None else 1
    runner = configure_runner(
        dit_model, vae_model, base_cache_dir=model_dir, dit_cache=dit_cache,
        vae_cache=vae_cache,
        block_swap_config={"blocks_to_swap": blocks_to_swap}, tiling=tiling,
        quant=quant, vae_quant=vae_quant, device=device, seed=seed,
        dit_cfg=dit_cfg or DIT_3B, vae_cfg=VAE_V3,
        attention_mode=attention_mode, tensor_parallel=tp)
    if mesh is not None:
        runner.attach_mesh(mesh)
    return runner


@contextmanager
def _debug_phase(debug: Optional[Debug], profile: str, timer: str,
                 message: str, checkpoint: str):
    """One phase under `debug`'s profiler trace and timer, then a memory
    checkpoint (the JAX CLI's process_frames); nothing without a Debug."""
    if debug is None:
        yield
        return
    with debug.profile(profile), debug.timer(timer, message):
        yield
    debug.checkpoint(checkpoint)


def process_frames(runner: VideoDiffusionRunner, frames: np.ndarray,
                   text_embeds, resolution: int = 1080, seed: int = 42,
                   batch_size: int = 5, temporal_overlap: int = 0,
                   max_resolution: int = 0, color_correction: str = "lab",
                   prepend_frames: int = 0, noise_override=None,
                   uniform_batch_size: bool = False,
                   input_noise_scale: float = 0.0,
                   latent_noise_scale: float = 0.0,
                   tile_debug: str = "false", debug: Optional[Debug] = None):
    """Run the 4 phases over one in-memory frame block (T, H, W, 3 or 4) in
    [0, 1], with the runner's VAE tiling. Returns (frames out (T, H', W',
    3 or 4) in [0, 1], the request record: the span `request` around the
    phases, each phase's wall and host seconds, their steps' spans and the
    copy counters, utils/spans.py). With a utils.debug.Debug, each phase
    runs under its profiler trace and timer and is followed by a memory
    checkpoint, as in the JAX CLI."""
    ctx = pipeline.setup_generation_context(runner.device,
                                            tile_debug=tile_debug)
    ctx["text_embeds"] = text_embeds
    with spans.recording(ctx["timings"]), spans.span("request"):
        if prepend_frames > 0:
            frames = pipeline.pad_video_temporal(
                frames, count=prepend_frames, prepend=True)
        if debug is not None:
            debug.checkpoint("pre_phase1")
        with _debug_phase(debug, "phase1_encode", "phase1_encoding",
                          "Phase 1: VAE encoding complete", "post_phase1"):
            ctx = pipeline.encode_all_batches(
                runner, ctx, frames, batch_size=batch_size,
                uniform_batch_size=uniform_batch_size, seed=seed,
                temporal_overlap=temporal_overlap, resolution=resolution,
                max_resolution=max_resolution,
                input_noise_scale=input_noise_scale)
        with _debug_phase(debug, "phase2_upscale", "phase2_upscaling",
                          "Phase 2: DiT upscaling complete", "post_phase2"):
            ctx = pipeline.upscale_all_batches(
                runner, ctx, seed=seed, latent_noise_scale=latent_noise_scale,
                noise_override=noise_override)
        with _debug_phase(debug, "phase3_decode", "phase3_decoding",
                          "Phase 3: VAE decoding complete", "post_phase3"):
            ctx = pipeline.decode_all_batches(runner, ctx)
        with _debug_phase(debug, "phase4_postprocess",
                          "phase4_postprocessing",
                          "Phase 4: Post-processing complete", "post_phase4"):
            ctx = pipeline.postprocess_all_batches(
                ctx, color_correction=color_correction,
                prepend_frames=prepend_frames)
    if debug is not None:
        debug.summary(runner.streamed_dit.stats.summary()
                      if runner.streamed_dit is not None else None)
    return ctx["final_video"], ctx["timings"]


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    io = p.add_argument_group("Input/Output")
    io.add_argument("input", type=str, nargs="?", default=None,
                    help="video, image, directory, or .npy frames "
                         "(T, H, W, 3 or 4) in [0, 1]")
    io.add_argument("--output", type=str, default=None)
    io.add_argument("--output_format", type=str, default=None,
                    choices=["mp4", "png", None],
                    help="video and directory inputs: mp4 (default) or a "
                         "png per frame; a .npy input writes .npy unless "
                         "this or a non-.npy --output is given")
    io.add_argument("--model_dir", type=str, default="./models",
                    help="directory searched for the checkpoints (after "
                         "$SEEDVR2_MODEL_PATHS) and first for {pos,neg}_emb")

    m = p.add_argument_group("Model selection")
    m.add_argument("--dit_model", type=str, default=DEFAULT_DIT,
                   help="reference-layout 3B or 7B DiT: .safetensors (fp16, "
                        "bf16, fp32, fp8 or the 7B fp8-mixed file), .pth / "
                        ".pt, or .gguf; 'random': the 3B with random "
                        "weights from --seed")
    m.add_argument("--vae_model", type=str, default=DEFAULT_VAE,
                   help="reference-layout VAE .safetensors (the VAE_V3 or "
                        "the legacy video_vae.py layout); 'random': VAE_V3 "
                        "with random weights from --seed")

    proc = p.add_argument_group("Processing")
    proc.add_argument("--resolution", type=int, default=1080)
    proc.add_argument("--max_resolution", type=int, default=0)
    proc.add_argument("--batch_size", type=int, default=5)
    proc.add_argument("--uniform_batch_size", action="store_true",
                      help="pad a short trailing batch to --batch_size "
                           "frames")
    proc.add_argument("--seed", type=int, default=42)
    proc.add_argument("--skip_first_frames", type=int, default=0)
    proc.add_argument("--load_cap", type=int, default=0)
    proc.add_argument("--chunk_size", type=int, default=0,
                      help="frames per streaming chunk (0 = whole video)")
    proc.add_argument("--prepend_frames", type=int, default=0)
    proc.add_argument("--temporal_overlap", type=int, default=0)

    q = p.add_argument_group("Quality")
    q.add_argument("--color_correction", type=str, default="lab",
                   choices=color_fix.METHODS)
    q.add_argument("--input_noise_scale", type=float, default=0.0,
                   help="blend N(0, 0.05) noise into the input with weight "
                        "scale / 2 before encoding")
    q.add_argument("--latent_noise_scale", type=float, default=0.0,
                   help="move the condition latent to the shifted timestep "
                        "1000 * scale before the DiT")

    v = p.add_argument_group("VAE tiling")
    v.add_argument("--vae_encode_tiled", action="store_true")
    v.add_argument("--vae_encode_tile_size", type=_tile_size, default=1024,
                   help="tile side in px, or 'auto': the fewest-tiles grid "
                        "that fits the card, from memory probes run on it")
    v.add_argument("--vae_encode_tile_overlap", type=int, default=128)
    v.add_argument("--vae_decode_tiled", action="store_true")
    v.add_argument("--vae_decode_tile_size", type=_tile_size, default=1024,
                   help="tile side in px, or 'auto' (see encode)")
    v.add_argument("--vae_decode_tile_overlap", type=int, default=128)
    v.add_argument("--tile_debug", type=str, default="false",
                   choices=pipeline.TILE_DEBUG,
                   help="draw the last tiled encode's or decode's tile "
                        "outlines over the output")
    v.add_argument("--tile_mode", type=str, default="uniform",
                   choices=TILE_MODES,
                   help="uniform = even same-shape tile grid; ref = the "
                        "reference's stride-sweep layout")

    perf = p.add_argument_group("Performance")
    perf.add_argument("--preset", type=str, default=None,
                      choices=["quality", "throughput"],
                      help="flag bundle, explicit flags win: 'quality' = "
                           "the defaults; 'throughput' = w8a8 DiT, uniform "
                           "tiled VAE with 1536 px encode / 1088 px decode "
                           "tiles at 32 / 48 px overlap")
    perf.add_argument("--attention_mode", type=str, default="flash",
                      choices=["flash", "xla", "sdpa", "flash_attn"],
                      help="flash = the hand-written attention kernels; "
                           "xla/sdpa = torch's scaled_dot_product_attention")
    perf.add_argument("--quant", type=str, default="none",
                      choices=QUANT_MODES,
                      help="DiT serving quantization: q8 = Q8_0 int8 "
                           "weights with per-32 scales through a "
                           "dequantizing GEMM (GGUF files keep their Q8_0 "
                           "blocks); q4k = GGUF Q4_K/Q5_K served in their "
                           "native affine layout (float files: as q8); q4 = "
                           "post-training 4-bit affine quantization of a "
                           "float checkpoint (same kernel as q4k; stored "
                           "one int8 per quant, 1.25 B/weight); w8a8 = "
                           "per-channel int8 weights, per-row int8 "
                           "activations")
    perf.add_argument("--vae_quant", type=str, default="none",
                      choices=["none", "int8"],
                      help="int8: the VAE decoder's 3x3x3 resnet convs run "
                           "as int8 convs (per-frame activation scale, "
                           "per-channel weight scales) through a "
                           "hand-written kernel; experimental, its speed "
                           "is in PERF.md. --preset throughput does not "
                           "set it")
    perf.add_argument("--data_parallel", type=str, default="auto",
                      choices=["auto", "off"],
                      help="spread batches over every card of the process "
                           "group (torchrun, or one worker a local card "
                           "started by this CLI; replaces the reference's "
                           "--cuda_device fan-out)")
    perf.add_argument("--tensor_parallel", type=int, default=1,
                      help="shard the DiT's attention heads / mlp hidden "
                           "over this many cards (parallel/tp.py); composes "
                           "with data parallel (dp = cards / "
                           "tensor_parallel)")
    perf.add_argument("--num_hosts", type=int, default=1,
                      help="multi-host frame fan-out: run the same command "
                           "on every host with its --host_index, then once "
                           "with --join_parts")
    perf.add_argument("--host_index", type=int, default=None,
                      help="this host's index in [0, num_hosts); defaults "
                           "to the process group's rank (0 without one)")
    perf.add_argument("--join_parts", action="store_true",
                      help="assemble the per-host .partN.npy segments into "
                           "the final output (Hann-blended seams, streamed "
                           "to the writer one segment at a time)")
    perf.add_argument("--coordinator_address", type=str, default=None,
                      help="host:port of host 0 for torch.distributed's "
                           "rendezvous of a --num_hosts fleet; optional "
                           "(the file-based fan-out needs only a shared "
                           "path)")
    perf.add_argument("--compile_dit", action="store_true",
                      help="no-op (the hot path is hand-written kernels)")
    perf.add_argument("--compile_vae", action="store_true",
                      help="no-op (the hot path is hand-written kernels)")

    bs = p.add_argument_group("Memory")
    bs.add_argument("--blocks_to_swap", type=int, default=0,
                    help="stream the last N transformer blocks from host "
                         "RAM (auto-engages for larger-than-HBM models)")
    bs.add_argument("--swap_io_components", action="store_true",
                    help="accepted for API compat (IO params always stay "
                         "in HBM; they are <1%% of the model)")

    c = p.add_argument_group("Caching")
    c.add_argument("--cache_dit", action="store_true")
    c.add_argument("--cache_vae", action="store_true")

    pr = p.add_argument_group("Parity")
    pr.add_argument("--parity_check", action="store_true",
                    help="after upscaling, score the output against a "
                         "reference capture (--parity_ref) and print a "
                         "one-line JSON PSNR report")
    pr.add_argument("--parity_ref", type=str, default=None,
                    help="reference output capture (.npy [T,H,W,C] in "
                         "[0,1], or an image file)")
    pr.add_argument("--parity_min_psnr", type=float, default=None,
                    help="exit non-zero if PSNR falls below this dB value")
    pr.add_argument("--convert_embeddings", nargs=2, default=None,
                    metavar=("SRC_DIR", "DST_DIR"),
                    help="convert pos_emb.pt/neg_emb.pt from SRC_DIR into "
                         ".npy files in DST_DIR, then exit")
    pr.add_argument("--allow_zero_embeddings", action="store_true",
                    help="benchmark-only: run a published-width model with "
                         "zero text embeddings if none resolve (default: "
                         "hard error — the packaged assets normally make "
                         "this unreachable)")

    d = p.add_argument_group("Debug")
    d.add_argument("--doctor", action="store_true",
                   help="print an environment health report (versions, "
                        "OpenCV, native libraries, caches, model/asset "
                        "resolution, a probe of the card) and exit: 0 = "
                        "the card computed, 3 = unavailable")
    d.add_argument("--device", type=str, default="auto",
                   choices=["auto", "cpu", "cuda"],
                   help="auto / cuda = the GPU (raises when none is "
                        "visible); cpu = the kernels' plain versions")
    d.add_argument("--debug", action="store_true")
    d.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler chrome trace per phase")
    args = p.parse_args(argv)
    if args.preset == "throughput":
        for name, val in THROUGHPUT_PRESET.items():
            if getattr(args, name) == p.get_default(name):
                setattr(args, name, val)
    if args.resolution <= 0:
        p.error("--resolution must be positive")
    if args.max_resolution < 0:
        p.error("--max_resolution must be >= 0")
    if args.batch_size < 1:
        p.error("--batch_size must be >= 1")
    if args.chunk_size < 0 or args.temporal_overlap < 0:
        p.error("--chunk_size/--temporal_overlap must be >= 0")
    if args.chunk_size and args.temporal_overlap >= args.chunk_size:
        p.error("--temporal_overlap must be smaller than --chunk_size")
    if args.seed < 0:
        p.error("--seed must be >= 0")
    if args.tensor_parallel < 1:
        p.error("--tensor_parallel must be >= 1")
    noops = [f"--{n}" for n in
             ("compile_dit", "compile_vae", "swap_io_components")
             if getattr(args, n)]
    if noops:
        print(f"[seedvr2] note: {', '.join(noops)} accepted for API "
              "compatibility but a no-op here (the hot path is hand-written "
              "kernels, not compiled graphs; IO params always stay on the "
              "card)", file=sys.stderr, flush=True)
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


def default_output_path(input_path: str, out_format: str) -> str:
    base, _ = os.path.splitext(input_path)
    suffix = time.strftime("_upscaled_%Y%m%d_%H%M%S")
    ext = ".mp4" if out_format == "mp4" else ".png"
    return base + suffix + ext


def resolve_device(name: str) -> torch.device:
    """--device: auto and cuda are the current GPU (in a process group, the
    rank's card: parallel.mesh.rank_device) and raise without one."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} but no CUDA device is visible")
    if dist.is_initialized():
        return rank_device("cuda")
    return torch.device("cuda", torch.cuda.current_device())


def build_mesh(args, n_devices: int) -> Optional[Mesh]:
    """The mesh the CLI's parallelism flags ask for, or None (one device),
    with the JAX CLI's rules and messages: --tensor_parallel T shards the
    DiT over a 'tp' axis of extent T; --data_parallel auto spreads batches
    over the remaining devices (dp = n_devices // T). dp off + T > 1 uses
    only T devices. n_devices: the process group's ranks (one a device);
    every rank calls this."""
    tp = getattr(args, "tensor_parallel", 1)
    dp_auto = getattr(args, "data_parallel", "auto") == "auto"
    if tp > 1:
        if n_devices % tp:
            raise ValueError(
                f"--tensor_parallel {tp} does not divide the "
                f"{n_devices} local devices")
        dp = n_devices // tp if dp_auto else 1
        return make_mesh(dp * tp, axis_names=("dp", "tp"), shape=(dp, tp))
    if dp_auto and n_devices > 1:
        return make_mesh(n_devices, axis_names=("dp",))
    return None


def _fleet_group(args) -> bool:
    """Whether the process group is a --num_hosts fleet's (one process a
    host, made by multihost.distributed_init) rather than this host's (a
    launcher's, WORLD_SIZE in the environment: torchrun or the CLI's own
    workers), over whose ranks the mesh is laid."""
    return args.num_hosts > 1 and "WORLD_SIZE" not in os.environ


def _n_devices(args) -> int:
    """Devices the mesh may take: the ranks of this host's process group,
    one a card (1 outside one, or in a fleet's group)."""
    if dist.is_initialized() and not _fleet_group(args):
        return dist.get_world_size()
    return 1


def _writes(args) -> bool:
    """Whether this process writes the output: rank 0 of this host's
    process group (every host of a --num_hosts fleet writes its own
    segment)."""
    return (not dist.is_initialized() or _fleet_group(args)
            or dist.get_rank() == 0)


def runner_from_args(args, debug: Debug) -> VideoDiffusionRunner:
    """The runner the flags ask for, through make_runner (configure_runner)
    with the attention mode, the memory and cache flags and the mesh of the
    parallel flags (build_mesh; a flag it rejects exits 2)."""
    device = resolve_device(args.device)
    try:
        mesh = build_mesh(args, _n_devices(args))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
    if mesh is not None and not mesh.member:
        debug.log("outside the mesh the flags ask for: nothing to do",
                  category="setup", force=True)
        sys.exit(0)

    def name(n):
        return None if n == RANDOM_WEIGHTS else n

    t0 = time.perf_counter()
    runner = make_runner(
        device, args.seed, name(args.dit_model), name(args.vae_model),
        quant=args.quant, tiling=tiling_from_args(args),
        vae_quant=args.vae_quant, model_dir=args.model_dir,
        blocks_to_swap=args.blocks_to_swap, dit_cache=args.cache_dit,
        vae_cache=args.cache_vae, attention_mode=args.attention_mode,
        **({} if mesh is None else {"mesh": mesh}))
    if mesh is not None:
        layout = " x ".join(f"{ax}={n}" for ax, n in mesh.shape.items())
        debug.log(f"multi-card serving over {layout}", category="setup",
                  force=True)
    debug.log(f"runner ready in {time.perf_counter() - t0:.2f}s "
              f"({args.dit_model}, {args.vae_model}, attention "
              f"{args.attention_mode}, on {device})", category="setup")
    return runner


def _text_embeds(args, runner, debug):
    # the model dir, then this package's directory (the JAX CLI's own
    # directory), then the packaged embeddings
    return load_text_embeddings(
        [args.model_dir, os.path.dirname(os.path.abspath(__file__))], debug,
        txt_dim=runner.dit_cfg.txt_in_dim,
        allow_zero=args.allow_zero_embeddings)


def _frames(runner, frames, embeds, args, debug, prepend_frames=0):
    """process_frames with the flags' options."""
    return process_frames(
        runner, frames, embeds, resolution=args.resolution, seed=args.seed,
        batch_size=args.batch_size, temporal_overlap=args.temporal_overlap,
        max_resolution=args.max_resolution,
        color_correction=args.color_correction,
        prepend_frames=prepend_frames,
        uniform_batch_size=args.uniform_batch_size,
        input_noise_scale=args.input_noise_scale,
        latent_noise_scale=args.latent_noise_scale,
        tile_debug=args.tile_debug, debug=debug)


def _report(runner, out_path, n_frames, timings):
    print(f"wrote {out_path} ({n_frames} frames); request record: "
          + spans.format_record(timings), file=sys.stderr)
    if runner.streamed_dit is not None:
        stats = runner.streamed_dit.stats
        print(f"BlockSwap (keep {runner.streamed_dit.keep_blocks}/"
              f"{runner.dit_cfg.num_layers} blocks on the card): "
              f"{stats.summary()} {stats.transfer()}", file=sys.stderr)


def _video_output(args):
    """(reader class, .npy out?, output format, output path) of a video or
    .npy input."""
    array = video_io.detect_input_type(args.input) == "array"
    npy_out = array and args.output_format is None and (
        args.output is None or args.output.endswith(".npy"))
    out_format = "npy" if npy_out else (args.output_format or "mp4")
    out_path = args.output or (
        os.path.splitext(args.input)[0] + "_upscaled.npy" if npy_out
        else default_output_path(args.input, out_format))
    reader = video_io.ArrayReader if array else video_io.VideoReader
    return reader, npy_out, out_format, out_path


def process_video(args, debug):
    """A video or a .npy array, streamed --chunk_size frames at a time (the
    JAX CLI's chunk loop); under --num_hosts, this host's frame range or
    the join (_process_video_multihost)."""
    if args.num_hosts > 1:
        return _process_video_multihost(args, debug)
    reader_cls, npy_out, out_format, out_path = _video_output(args)
    reader = reader_cls(args.input, args.skip_first_frames, args.load_cap)
    runner = runner_from_args(args, debug)
    writes = _writes(args)
    embeds = _text_embeds(args, runner, debug)
    png_base = os.path.splitext(out_path)[0] if out_format == "png" else None
    png_index = 0

    chunk = args.chunk_size if args.chunk_size > 0 else max(reader.remaining, 1)
    overlap = args.temporal_overlap
    n_out = max(reader.remaining, 0)  # frames the output will hold
    writer = None
    held = None           # last `overlap` OUTPUT frames, not yet written
    prev_in_tail = None   # last `overlap` INPUT frames, re-fed to next chunk
    total_written = 0
    timings = {}
    # --parity_check needs the assembled output; only retain it when asked
    # (streaming normally never holds the full video in RAM)
    parity_frames = [] if args.parity_check else None
    t_start = time.perf_counter()

    first_chunk = True
    while reader.remaining > 0:
        frames = reader.read_frames(chunk)
        if frames.shape[0] == 0:
            break
        debug.log(f"Processing chunk of {frames.shape[0]} frames "
                  f"({reader.remaining} remaining)", category="video",
                  force=True)
        if prev_in_tail is not None:
            frames = np.concatenate([prev_in_tail, frames], axis=0)
        result, chunk_timings = _frames(
            runner, frames, embeds, args, debug,
            prepend_frames=args.prepend_frames if first_chunk else 0)
        for k, v in chunk_timings.items():
            timings[k] = timings.get(k, 0) + v
        if held is not None:
            # seam: blend the held previous tail with this chunk's re-decoded
            # head (same source frames) — Hann crossfade, then write once
            result = result.copy()
            result[:overlap, :, :, :3] = pipeline.blend_overlapping_frames(
                held[:, :, :, :3], result[:overlap, :, :, :3], overlap)
        if writer is None and png_base is None and writes:
            writer = (video_io.ArrayWriter(out_path, n_out, result.shape[1:])
                      if npy_out else
                      video_io.VideoWriter(out_path, reader.fps,
                                           result.shape[1:3]))

        def emit(frames_out):
            nonlocal total_written, png_index
            if writes and png_base is not None:
                for frame in frames_out:
                    video_io.write_image(f"{png_base}_{png_index:06d}.png",
                                         frame)
                    png_index += 1
            elif writes:
                writer.write_frames(frames_out)
            if parity_frames is not None:
                parity_frames.append(np.asarray(frames_out))
            total_written += frames_out.shape[0]

        if overlap > 0 and reader.remaining > 0 and result.shape[0] > overlap:
            emit(result[:-overlap])
            held = result[-overlap:]
            prev_in_tail = frames[-overlap:]
        else:
            emit(result)
            held = None
            prev_in_tail = None
        first_chunk = False
        # Per-chunk host-memory checkpoint: with --debug the RSS delta
        # between successive chunks makes the bounded-memory claim of
        # --chunk_size observable (a growing RSS across chunks = a leak;
        # reference tracks the same via psutil, memory_manager.py:166-208).
        debug.checkpoint(f"chunk_written[{total_written}]")

    if writer is not None:
        writer.close()
    reader.close()
    elapsed = time.perf_counter() - t_start
    fps = total_written / elapsed if elapsed > 0 else 0.0
    debug.log(f"Wrote {total_written} frames to {out_path} "
              f"({fps:.2f} frames/s end-to-end)", category="generation",
              force=True)
    _report(runner, out_path, total_written, timings)
    if parity_frames and writes:
        _parity_report(args, np.concatenate(parity_frames, axis=0))
    return out_path


def _process_video_multihost(args, debug):
    """Multi-host frame fan-out (parallel/multihost.py): this host
    processes its frame range into a .npy segment next to the output;
    --join_parts assembles the segments into the output, streamed one
    segment at a time into the video or .npy writer. The output path must
    be shared (or the segments copied) for the join."""
    reader_cls, npy_out, _, out_path = _video_output(args)
    probe = reader_cls(args.input, args.skip_first_frames, args.load_cap)
    total, fps = probe.remaining, probe.fps
    probe.close()
    ranges = multihost.frame_ranges(total, args.num_hosts,
                                    args.temporal_overlap)
    if args.join_parts:
        writer = None
        joined = 0
        for chunk in multihost.iter_joined_segments(
                out_path, args.num_hosts, args.temporal_overlap):
            if writer is None:
                writer = (video_io.ArrayWriter(out_path, total,
                                               chunk.shape[1:])
                          if npy_out else
                          video_io.VideoWriter(out_path, fps,
                                               chunk.shape[1:3]))
            writer.write_frames(chunk)
            joined += chunk.shape[0]
        if writer is not None:
            writer.close()
        debug.log(f"Joined {args.num_hosts} segments -> {out_path} "
                  f"({joined} frames)", category="generation", force=True)
        return out_path

    idx = _host_index(args)
    start, end = ranges[idx]
    debug.log(f"host {idx}/{args.num_hosts}: frames [{start}, {end}) of "
              f"{total}", category="setup", force=True)
    reader = reader_cls(args.input, args.skip_first_frames + start,
                        end - start)
    runner = runner_from_args(args, debug)
    frames = reader.read_frames(end - start)
    reader.close()
    result, timings = _frames(
        runner, frames, _text_embeds(args, runner, debug), args, debug,
        prepend_frames=args.prepend_frames if idx == 0 else 0)
    if not _writes(args):  # another worker of this host writes it
        return multihost.part_path(out_path, idx)
    path = multihost.save_segment(out_path, idx, result)
    debug.log(f"host {idx}: wrote segment {path} ({result.shape[0]} "
              "frames)", category="generation", force=True)
    _report(runner, path, result.shape[0], timings)
    return path


def _host_index(args) -> int:
    """This host's index in a --num_hosts fleet: --host_index, else the
    rank in the fleet's process group (0 without one). A host's own
    process group (its workers or torchrun's) does not say which host it
    is: there --host_index is required. Exits 2 outside [0, num_hosts)."""
    idx = args.host_index
    if idx is None:
        if dist.is_initialized() and not _fleet_group(args):
            print("error: --num_hosts under a launcher's process group "
                  "needs --host_index", file=sys.stderr)
            sys.exit(2)
        idx = multihost.default_host_index()
    if not 0 <= idx < args.num_hosts:
        print(f"error: --host_index {idx} outside [0, {args.num_hosts})",
              file=sys.stderr)
        sys.exit(2)
    return idx


def _parity_report(args, result):
    """--parity_check: score against the reference capture."""
    if not args.parity_check:
        return
    from .utils import parity

    if not args.parity_ref:
        parity.print_report({"parity": "no_capture",
                             "hint": "pass --parity_ref <capture.npy>"})
        return
    report = parity.compare_to_capture(result, args.parity_ref,
                                       args.parity_min_psnr)
    parity.print_report(report)
    if report.get("passed") is False:
        sys.exit(1)


def process_image(args, debug):
    frames = video_io.read_image(args.input)
    out_format = args.output_format or "png"
    out_path = args.output or default_output_path(args.input, out_format)
    runner = runner_from_args(args, debug)
    result, timings = _frames(runner, frames, _text_embeds(args, runner,
                                                           debug), args,
                              debug)
    if not _writes(args):
        return out_path
    video_io.write_image(out_path, result[0])
    debug.log(f"Wrote {out_path}", category="generation", force=True)
    _report(runner, out_path, 1, timings)
    _parity_report(args, result)
    return out_path


def process_directory(args, debug):
    frames = video_io.read_directory(args.input)
    out_format = args.output_format or "mp4"
    out_path = args.output or default_output_path(
        os.path.join(args.input, "frames"), out_format)
    runner = runner_from_args(args, debug)
    result, timings = _frames(runner, frames, _text_embeds(args, runner,
                                                           debug), args,
                              debug, prepend_frames=args.prepend_frames)
    if not _writes(args):
        return out_path
    if out_format == "mp4":
        writer = video_io.VideoWriter(out_path, 30.0, result.shape[1:3])
        writer.write_frames(result)
        writer.close()
    else:
        base, _ = os.path.splitext(out_path)
        for i, frame in enumerate(result):
            video_io.write_image(f"{base}_{i:05d}.png", frame)
    debug.log(f"Wrote {out_path}", category="generation", force=True)
    _report(runner, out_path, result.shape[0], timings)
    _parity_report(args, result)
    return out_path


def _local_workers(args) -> int:
    """Workers the CLI starts itself, one a local card: outside a process
    group and a launcher, on a host with more than one visible card, when
    the flags ask for them (--data_parallel auto: every card; off: the
    --tensor_parallel ones); a --num_hosts host too, but not the join.
    0: serve in this process."""
    if (dist.is_initialized() or "WORLD_SIZE" in os.environ
            or args.join_parts or args.device == "cpu"
            or args.input is None or args.doctor
            or args.convert_embeddings is not None
            or not torch.cuda.is_available()):
        return 0
    cards = torch.cuda.device_count()
    n = cards if args.data_parallel == "auto" else args.tensor_parallel
    return n if 1 < n <= cards else 0


def _worker(index: int, argv, port: int, n: int) -> None:
    """One local worker: torchrun's environment for rank `index` of `n`,
    then main."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(n), RANK=str(index),
                      LOCAL_RANK=str(index))
    main(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join_group(args) -> bool:
    """Join the process group the environment or the flags describe,
    before the first device use: a launcher's (WORLD_SIZE in the
    environment: torchrun, or this CLI's own workers; NCCL on cards, gloo
    with --device cpu), else a --num_hosts fleet's (at
    --coordinator_address, multihost.distributed_init; a failure warns).
    True when this call made the group (main destroys it at its end)."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ:
        if (args.num_hosts > 1 and args.coordinator_address
                and not args.join_parts):
            return multihost.distributed_init(args.coordinator_address,
                                              args.num_hosts, args.host_index)
        return False
    cuda = args.device != "cpu" and torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend="nccl" if cuda else "gloo",
                            init_method="env://")
    return True


def main(argv=None, debug: Optional[Debug] = None) -> Optional[str]:
    """Parse argv (default sys.argv) and run: the output path, or None
    after --convert_embeddings or when this call started local workers
    (_local_workers; they write the output); --doctor, input errors (code
    2) and a failed --parity_min_psnr (code 1) exit. debug: a Debug to log
    through instead of one built from --debug / --profile_dir (a caller
    that reads its checkpoints afterwards)."""
    args = parse_arguments(argv)
    if args.doctor:
        from .utils.doctor import run_doctor

        sys.exit(run_doctor(model_dir=args.model_dir))
    workers = _local_workers(args)
    if workers:
        import torch.multiprocessing as mp

        if workers % args.tensor_parallel:  # build_mesh's check, up front
            print(f"error: --tensor_parallel {args.tensor_parallel} does not "
                  f"divide the {workers} local devices", file=sys.stderr)
            sys.exit(2)
        argv = list(sys.argv[1:] if argv is None else argv)
        if args.num_hosts > 1 and args.host_index is None:
            # the workers' group is this host's: the host index comes from
            # the fleet's group, joined here and left before they start
            own_group = _join_group(args)
            argv += ["--host_index", str(_host_index(args))]
            if own_group:
                dist.destroy_process_group()
        mp.spawn(_worker, args=(argv, _free_port(), workers), nprocs=workers)
        return None
    own_group = _join_group(args)
    try:
        return _run(args, debug)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args, debug: Optional[Debug]) -> Optional[str]:
    """main's body, once the process group is settled."""
    if debug is None:
        debug = Debug(enabled=args.debug, profile_dir=args.profile_dir)
    debug.log_environment()
    if args.convert_embeddings is not None:
        from .utils import parity

        src, dst = args.convert_embeddings
        shapes = parity.convert_embeddings(src, dst)
        parity.print_report({"converted": {k: list(v)
                                           for k, v in shapes.items()},
                             "dst": dst})
        return None
    if args.input is None:
        print("error: input is required", file=sys.stderr)
        sys.exit(2)
    try:
        kind = video_io.detect_input_type(args.input)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
    if not os.path.exists(args.input):
        print(f"error: input not found: {args.input}", file=sys.stderr)
        sys.exit(2)
    if kind in ("video", "array"):
        return process_video(args, debug)
    if kind == "image":
        return process_image(args, debug)
    return process_directory(args, debug)


if __name__ == "__main__":
    main()
