"""The four SeedVR2 nodes on the port (the reference's src/interfaces/*.py;
counterpart of seedvr2_tpu.interfaces.nodes, held to it by
tests/test_torch_nodes.py).

The loaders return the JAX nodes' config dicts, key for key, so the
reference's workflows map 1:1. The upscaler builds its runner through
core/model_manager.configure_runner and runs the four phases of
core/pipeline.py with the arguments the JAX node passes. Device strings are
torch devices: "cuda:0" (the default; JAX's is "tpu:0") and "cuda" (the
current card) run on the card and raise without a GPU, "cpu" runs the
plain versions of the kernels. The runner holds one device, so a DiT and a
VAE dict on different devices raise. The model name `random` draws random
weights on the device from the request's seed, as the port CLI's does.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..cli import RANDOM_WEIGHTS
from ..core import pipeline
from ..core.model_manager import configure_runner
from ..core.runner import VAETiling
from ..utils.debug import Debug
from ..utils.model_registry import (DEFAULT_DIT, DEFAULT_VAE,
                                    get_available_models)
from ..utils.text_embeds import load_text_embeddings

DEFAULT_DEVICE = "cuda:0"


def _node_tile(v):
    """Node tile-size value -> VAETiling form: 0 or "auto" means the
    memory-probed auto plan (utils/memplan), else (px, px)."""
    if v == 0 or v == "auto":
        return "auto"
    return (int(v),) * 2


def _runner_device(dit: Dict[str, Any], vae: Dict[str, Any]) -> torch.device:
    """The one device of the DiT and VAE dicts: "cpu", or a card ("cuda"
    is the current one), which needs a visible GPU."""
    devices = [torch.device(d.get("device", DEFAULT_DEVICE))
               for d in (dit, vae)]
    if any(d.type == "cuda" for d in devices):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {devices[0]} / {devices[1]} but no "
                               "CUDA device is visible")
        devices = [torch.device("cuda", torch.cuda.current_device()
                                if d.index is None else d.index)
                   if d.type == "cuda" else d for d in devices]
    if devices[0] != devices[1]:
        raise ValueError(f"the DiT on {devices[0]} and the VAE on "
                         f"{devices[1]}: the runner holds one device")
    if devices[0].type not in ("cpu", "cuda"):
        raise ValueError(f"device {devices[0]}: the port runs on 'cuda[:N]' "
                         "or 'cpu'")
    return devices[0]


def _weights(name: str) -> Optional[str]:
    """configure_runner's model argument: None (random weights) for
    `random`, else the checkpoint name."""
    return None if name == RANDOM_WEIGHTS else name


class SeedVR2LoadDiTModel:
    """DiT loader node -> config dict (dit_model_loader.py:131-180)."""

    @classmethod
    def execute(cls, model: str = DEFAULT_DIT, device: str = DEFAULT_DEVICE,
                offload_device: str = "none", cache_model: bool = False,
                blocks_to_swap: int = 0, swap_io_components: bool = False,
                attention_mode: str = "flash", quant: str = "none",
                torch_compile_args: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        if (blocks_to_swap > 0 or swap_io_components) and \
                offload_device in ("none", device):
            raise ValueError(
                "BlockSwap requires offload_device set and != device")
        if cache_model and offload_device == "none":
            raise ValueError("cache_model requires offload_device")
        return {
            "model": model,
            "device": device,
            "offload_device": offload_device,
            "cache_model": cache_model,
            "blocks_to_swap": blocks_to_swap,
            "swap_io_components": swap_io_components,
            "attention_mode": attention_mode,
            "quant": quant,
            "torch_compile_args": torch_compile_args,
        }

    @classmethod
    def available_models(cls, model_dir: Optional[str] = None):
        return get_available_models("dit", model_dir)


class SeedVR2LoadVAEModel:
    """VAE loader node -> config dict (vae_model_loader.py:165-215)."""

    @classmethod
    def execute(cls, model: str = DEFAULT_VAE, device: str = DEFAULT_DEVICE,
                offload_device: str = "none", cache_model: bool = False,
                encode_tiled: bool = False, encode_tile_size: int = 512,
                encode_tile_overlap: int = 64, decode_tiled: bool = False,
                decode_tile_size: int = 512, decode_tile_overlap: int = 64,
                tile_debug: str = "false", tile_mode: str = "uniform",
                torch_compile_args: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        if cache_model and offload_device == "none":
            raise ValueError("cache_model requires offload_device")
        return {
            "model": model,
            "device": device,
            "offload_device": offload_device,
            "cache_model": cache_model,
            "encode_tiled": encode_tiled,
            "encode_tile_size": encode_tile_size,
            "encode_tile_overlap": encode_tile_overlap,
            "decode_tiled": decode_tiled,
            "decode_tile_size": decode_tile_size,
            "decode_tile_overlap": decode_tile_overlap,
            "tile_debug": tile_debug,
            "tile_mode": tile_mode,
            "torch_compile_args": torch_compile_args,
        }

    @classmethod
    def available_models(cls, model_dir: Optional[str] = None):
        return get_available_models("vae", model_dir)


class SeedVR2TorchCompileSettings:
    """Compile settings node (torch_compile_settings.py:97-122). The dict is
    kept for workflow compatibility; the port accepts it and ignores it, as
    JAX does and as the port CLI's --compile_dit does: its kernels are
    written by hand."""

    @classmethod
    def execute(cls, backend: str = "inductor", mode: str = "default",
                fullgraph: bool = False, dynamic: bool = False,
                dynamo_cache_size_limit: int = 64,
                dynamo_recompile_limit: int = 128) -> Dict[str, Any]:
        return {
            "backend": backend,
            "mode": mode,
            "fullgraph": fullgraph,
            "dynamic": dynamic,
            "dynamo_cache_size_limit": dynamo_cache_size_limit,
            "dynamo_recompile_limit": dynamo_recompile_limit,
        }


class SeedVR2VideoUpscaler:
    """Main upscaler node: frames (N, H, W, C) in [0, 1] -> upscaled frames
    (video_upscaler.py:225-560), with weighted progress reporting (encode
    .2 / upscale .25 / decode .5 / postprocess .05).

    The dicts' cache_model keeps the DiT / the VAE in core/model_cache.py
    (both: the runner too); blocks_to_swap streams the DiT's last blocks
    from pinned host memory (ops/offload.py), which is what offload_device
    names; with 0 the card's memory decides, as in configure_runner."""

    PHASE_WEIGHTS = {"Phase 1: Encoding": 0.2, "Phase 2: Upscaling": 0.25,
                     "Phase 3: Decoding": 0.5, "Phase 4: Post-processing": 0.05}

    @classmethod
    def execute(cls, image: np.ndarray, dit: Dict[str, Any],
                vae: Dict[str, Any], seed: int, resolution: int = 1080,
                max_resolution: int = 0, batch_size: int = 5,
                uniform_batch_size: bool = False, temporal_overlap: int = 0,
                prepend_frames: int = 0, color_correction: str = "wavelet",
                input_noise_scale: float = 0.0,
                latent_noise_scale: float = 0.0,
                offload_device: str = "none", enable_debug: bool = False,
                model_dir: str = "./models",
                progress_callback=None) -> np.ndarray:
        debug = Debug(enabled=enable_debug)
        runner = configure_runner(
            dit_model=_weights(dit["model"]), vae_model=_weights(vae["model"]),
            base_cache_dir=model_dir,
            dit_cache=dit.get("cache_model", False),
            vae_cache=vae.get("cache_model", False),
            block_swap_config={
                "blocks_to_swap": dit.get("blocks_to_swap", 0),
                "swap_io_components": dit.get("swap_io_components", False),
            },
            # tile_size: an int px side, or 0 / "auto" = memory-probed plan
            # (utils/memplan); node widgets are numeric, so 0 is the
            # node-friendly spelling of "auto"
            tiling=VAETiling(
                encode_tiled=vae.get("encode_tiled", False),
                encode_tile_size=_node_tile(vae.get("encode_tile_size", 512)),
                encode_tile_overlap=(vae.get("encode_tile_overlap", 64),) * 2,
                decode_tiled=vae.get("decode_tiled", False),
                decode_tile_size=_node_tile(vae.get("decode_tile_size", 512)),
                decode_tile_overlap=(vae.get("decode_tile_overlap", 64),) * 2,
                tile_mode=vae.get("tile_mode", "uniform")),
            quant=dit.get("quant", "none"),
            device=_runner_device(dit, vae), seed=seed,
            attention_mode=dit.get("attention_mode", "flash"),
        )

        frames = np.asarray(image, dtype=np.float32)
        if prepend_frames > 0:
            frames = pipeline.pad_video_temporal(frames, count=prepend_frames,
                                                 prepend=True)

        def weighted_progress(cur, total, _frames, phase):
            if progress_callback is None:
                return
            done = 0.0
            for name, w in cls.PHASE_WEIGHTS.items():
                if name == phase:
                    done += w * (cur / max(total, 1))
                    break
                done += w
            progress_callback(done)

        ctx = pipeline.setup_generation_context(runner.device)
        ctx["text_embeds"] = load_text_embeddings(
            [model_dir, "."], debug, txt_dim=runner.dit_cfg.txt_in_dim)
        with debug.timer("phase1_encoding", "Phase 1: VAE encoding complete"):
            ctx = pipeline.encode_all_batches(
                runner, ctx, frames, batch_size=batch_size,
                uniform_batch_size=uniform_batch_size, seed=seed,
                progress_callback=weighted_progress,
                temporal_overlap=temporal_overlap, resolution=resolution,
                max_resolution=max_resolution,
                input_noise_scale=input_noise_scale)
        with debug.timer("phase2_upscaling", "Phase 2: DiT upscaling complete"):
            ctx = pipeline.upscale_all_batches(
                runner, ctx, progress_callback=weighted_progress, seed=seed,
                latent_noise_scale=latent_noise_scale)
        with debug.timer("phase3_decoding", "Phase 3: VAE decoding complete"):
            ctx = pipeline.decode_all_batches(
                runner, ctx, progress_callback=weighted_progress)
        with debug.timer("phase4_postprocessing",
                         "Phase 4: Post-processing complete"):
            ctx = pipeline.postprocess_all_batches(
                ctx, progress_callback=weighted_progress,
                color_correction=color_correction,
                prepend_frames=prepend_frames)
        return ctx["final_video"]
