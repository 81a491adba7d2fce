"""Model lifecycle: checkpoint (or seed) -> DiT and VAE -> configured runner,
with the memory plan and the model cache.

Port of the JAX package's configure_runner and its memory planner
(seedvr2_tpu.core.model_manager:174-435). The DiT loads to host memory
first, so the planner sees its bytes before anything lands on the card;
its serving conversion (--quant) then runs a block at a time on the card,
each converted block returning to host memory. The plan, as in JAX:

 - `_plan_block_streaming`: stream the DiT's blocks from pinned host memory
   (ops.offload.StreamedNaDiT) when `blocks_to_swap` > 0 (keep the first
   num_layers - blocks_to_swap) or when the DiT exceeds
   `_AUTO_SWAP_FRACTION` of the card (keep as many as fit in that share
   beside the IO parameters);
 - else per-phase offload when it exceeds `_PHASE_OFFLOAD_FRACTION`: the
   DiT leaves the card during the VAE phases (runner.set_phase_offload);
 - else the whole DiT goes to the card.

The card's limit is utils.memplan.memory_limit (total memory times the
per-process fraction); the CPU has none, and plans resident. With no
checkpoint the models are drawn from `seed` on the runner's device (the
DiT of `dit_cfg`, then VAE_V3), as the JAX CLI's random-weight tests do;
a random DiT that would go to the card whole anyway is drawn there
directly. Tensor parallelism (`shard_ways`) stays a parameter fixed at 1.
"""

import logging
import os
from dataclasses import replace
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..models.dit.nadit import NaDiT, init_dit
from ..models.vae.pipeline_vae import VideoVAE, init_vae_params
from ..ops.attention import resolve_attention_mode
from ..ops.offload import HostCopy, StreamedNaDiT, module_bytes, pack, place
from ..utils import memplan
from ..utils.constants import find_model_path
from ..utils.downloads import download_weight
from .configs import DIT_3B, VAE_V3, DiTConfig, RunnerConfig, VAEConfig
from .loader import (QUANT_MODES, load_vae_checkpoint, quantize_converts,
                     quantize_dit, read_dit_model)
from .model_cache import get_global_cache
from .runner import VAETiling, VideoDiffusionRunner

log = logging.getLogger(__name__)

# fraction of the card the resident DiT weights may claim before host
# streaming auto-engages (the rest is activations, VAE weights and scratch)
_AUTO_SWAP_FRACTION = 0.70
# above this fraction, the resident DiT crowds out the VAE decoder's
# workspace at large tiles -> engage per-phase offload (the reference's
# manage_model_device policy, memory_manager.py:573-930): the DiT leaves the
# card during the VAE phases, restored at phase-2 entry
_PHASE_OFFLOAD_FRACTION = 0.30


def _tree_bytes(module: nn.Module) -> int:
    """Every parameter and buffer of the module, quantised buffers and K3's
    joined gate / up weight included (ops.offload.module_bytes)."""
    return module_bytes(module)


def _device_limit(device) -> Optional[int]:
    """Bytes the card lets this process hold; None on the CPU (host memory,
    no tiering needed), as JAX's _hbm_bytes_limit is on its CPU platform."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return memplan.memory_limit(device)


def _per_chip_dit_bytes(model: NaDiT, shard_ways: int) -> int:
    """Resident bytes per card: the transformer blocks shard over the tp
    axis (their projections dominate), the IO weights replicate."""
    total = _tree_bytes(model)
    if shard_ways <= 1:
        return total
    blocks_bytes = sum(_tree_bytes(b) for b in model.blocks)
    return (total - blocks_bytes) + blocks_bytes // shard_ways


def _plan_block_streaming(model: NaDiT, blocks_to_swap: int, device,
                          shard_ways: int = 1) -> Optional[int]:
    """Decide host-memory weight tiering (the reference's BlockSwap,
    src/optimization/blockswap.py:88-456). Returns keep_blocks (blocks kept
    on the card) or None for no streaming. An explicit blocks_to_swap > 0
    forces it; otherwise it auto-engages when the weights would crowd out
    activations (7B bf16 = 16.4 GB > 70 % of a 24 GB card)."""
    n = model.cfg.num_layers
    if blocks_to_swap > 0:
        return max(0, n - min(blocks_to_swap, n))
    limit = _device_limit(device)
    if limit is None:
        return None
    per_chip = _per_chip_dit_bytes(model, shard_ways)
    if per_chip <= _AUTO_SWAP_FRACTION * limit:
        return None
    # streaming budgets full, unsharded bytes (it does not compose with tp)
    block_bytes = _tree_bytes(model.blocks[0])
    io_bytes = _tree_bytes(model) - sum(_tree_bytes(b) for b in model.blocks)
    resident_budget = _AUTO_SWAP_FRACTION * limit - io_bytes
    keep = int(max(0, min(n, resident_budget // max(block_bytes, 1))))
    log.warning(
        "DiT weights %.1f GB/card exceed %.0f%% of the card (%.1f GB); "
        "auto-engaging host block streaming (keep %d/%d blocks resident)",
        per_chip / 1e9, _AUTO_SWAP_FRACTION * 100, limit / 1e9, keep, n)
    return keep


def quantize_dit_by_block(model: NaDiT, quant: str, from_gguf: bool, device,
                          min_dim: int = 1024, align: int = 256) -> NaDiT:
    """quantize_dit for a DiT in host memory: each block, then the IO
    modules, goes to `device`, converts there and comes back to host memory
    packed (shared storages stay shared), so the card never holds more than
    one block and the CPU converts nothing (on a CPU device the parts
    convert in place). The result equals quantize_dit's."""
    if not quantize_converts(quant, from_gguf):
        return quantize_dit(model, quant, from_gguf, min_dim, align)
    head = nn.ModuleDict({name: child for name, child in
                          model.named_children() if name != "blocks"})
    for part in (*model.blocks, head):
        part.to(device)
        quantize_dit(part, quant, from_gguf, min_dim, align)
        pack(part, "cpu")
    for name, child in head.items():  # a converted top-level linear
        setattr(model, name, child)
    return model


def _random_dit(cfg: DiTConfig, quant: str, device, dtype, gen,
                blocks_to_swap: int, min_dim: int, align: int) -> NaDiT:
    """The random DiT of `cfg` drawn from `gen` on `device`, converted per
    quant. Drawn on the card directly when the dense model would go there
    whole (a converted one is smaller, so its plan is resident too), else
    into host memory (the same values: the draws run on the generator's
    device) and converted a block at a time on the card."""
    with torch.device("meta"):
        meta = NaDiT(cfg, dtype=dtype)
    limit = _device_limit(device)
    if limit is None or (blocks_to_swap <= 0 and _tree_bytes(meta)
                         <= _PHASE_OFFLOAD_FRACTION * limit):
        return quantize_dit(init_dit(cfg, device, dtype, generator=gen),
                            quant, False, min_dim, align)
    model = init_dit(cfg, "cpu", dtype, generator=gen)
    return quantize_dit_by_block(model, quant, False, device, min_dim, align)


def _resolve(name: str, base_dir: Optional[str]) -> str:
    """A checkpoint name's path: found on the search path, else downloaded
    into base_dir (utils.downloads.download_weight, which raises IOError
    when it cannot obtain the file), as JAX's configure_runner resolves. A
    missing path with a directory part names no file of the registry's
    repositories, so it raises FileNotFoundError instead of asking one."""
    path = find_model_path(name, base_dir)
    if path is not None:
        return path
    if os.path.dirname(name):
        raise FileNotFoundError(f"{name!r} not found")
    return download_weight(name, base_dir or "./models")


def configure_runner(
    dit_model: Optional[str] = None,
    vae_model: Optional[str] = None,
    base_cache_dir: Optional[str] = "./models",
    dit_cache: bool = False,
    vae_cache: bool = False,
    block_swap_config: Optional[Dict[str, Any]] = None,
    tiling: VAETiling = VAETiling(),
    quant: str = "none",
    vae_quant: str = "none",
    device="cuda",
    seed: int = 42,
    dit_cfg: Optional[DiTConfig] = None,
    vae_cfg: Optional[VAEConfig] = None,
    compute_dtype=torch.bfloat16,
    min_dim: int = 1024,
    align: int = 256,
    attention_mode: str = "flash",
) -> VideoDiffusionRunner:
    """Build (or fetch cached) a fully configured runner for a model pair.

    dit_model / vae_model: checkpoint names resolved by find_model_path
    (an existing path, $SEEDVR2_MODEL_PATHS, base_cache_dir, the ComfyUI
    roots), a missing file name downloaded into base_cache_dir with its
    registry checksum (utils/downloads.py; IOError when it cannot be
    obtained; a missing path raises FileNotFoundError), or
    None for random weights drawn from `seed` on `device`:
    the DiT of `dit_cfg` (DIT_3B when None), then the VAE of `vae_cfg`
    (VAE_V3), from one generator. block_swap_config {"blocks_to_swap": N}
    streams the last N blocks from pinned host memory; with 0 the plan
    follows the card's memory (module docstring). quant / vae_quant: the
    serving conversions (core/loader.py); min_dim / align their size rules
    (tests shrink them). attention_mode: the runner's (ops.attention:
    "flash", "xla" or an alias). dit_cache / vae_cache keep the placed DiT
    / the VAE across calls; both together keep the runner, keyed by every
    knob that shapes it, the attention mode among them (a changed knob
    resolves to another runner on the same cached models)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant={quant!r}; known: {QUANT_MODES}")
    device = torch.device(device)
    dit_cfg = dit_cfg or DIT_3B
    vae_cfg = vae_cfg or VAE_V3
    bs_cfg = dict(block_swap_config or {})
    blocks_to_swap = int(bs_cfg.get("blocks_to_swap", 0) or 0)
    cache = get_global_cache()
    dit_name = dit_model or f"random:{seed}:{dit_cfg}"
    vae_name = vae_model or f"random:{seed}:{dit_cfg}:{vae_cfg}"
    runner_key = "|".join(map(str, (
        dit_name, vae_name, tiling, quant, vae_quant, compute_dtype,
        blocks_to_swap, sorted(bs_cfg.items()), device, min_dim, align,
        resolve_attention_mode(attention_mode))))
    cached = cache.get_runner(runner_key)
    if cached is not None:
        log.info("Reusing cached runner")
        return cached

    dit_path = _resolve(dit_model, base_cache_dir) if dit_model else None
    vae_path = _resolve(vae_model, base_cache_dir) if vae_model else None
    gen = (torch.Generator(device).manual_seed(seed)
           if dit_path is None or vae_path is None else None)

    dit_key = f"{dit_path or dit_name}|{quant}|{compute_dtype}"
    hit = cache.get_dit(dit_key) if dit_cache else None
    if hit is not None and _plan(hit["model"], blocks_to_swap,
                                 device) != hit["plan"]:
        hit = None  # placed for another plan: build it again
    if hit is None:
        hit = _build_dit(dit_path, dit_cfg, quant, device, compute_dtype, gen,
                         blocks_to_swap, min_dim, align)
        if dit_cache:
            cache.set_dit(dit_key, hit)
    elif gen is not None:
        gen.set_state(hit["gen_state"])  # the VAE's draws follow the DiT's
    model = hit["model"]

    # conv_quant and the dtype are baked into the VAE, so the key covers them
    vae_key = f"{vae_path or vae_name}|{vae_quant}|{compute_dtype}"
    vae = cache.get_vae(vae_key) if vae_cache else None
    if vae is None:
        if vae_path is not None:
            vae_model_ = load_vae_checkpoint(vae_path, device, compute_dtype,
                                             vae_quant=vae_quant)
        else:
            vae_model_ = init_vae_params(replace(vae_cfg,
                                                 conv_quant=vae_quant),
                                         device, compute_dtype, generator=gen)
        vae = VideoVAE(vae_model_, compute_dtype)
        if vae_cache:
            cache.set_vae(vae_key, vae)

    runner = VideoDiffusionRunner(
        None if hit["streamed"] is not None else model, vae,
        RunnerConfig(dit=model.cfg, vae=vae.cfg), compute_dtype=compute_dtype,
        tiling=tiling, streamed_dit=hit["streamed"], device=device,
        attention_mode=attention_mode)
    if hit["host_copy"] is not None:
        runner.set_phase_offload(hit["host_copy"])
    if dit_cache and vae_cache:
        cache.set_runner(runner_key, runner)
    return runner


def _build_dit(dit_path, dit_cfg, quant, device, dtype, gen, blocks_to_swap,
               min_dim, align) -> Dict[str, Any]:
    """Load (or draw) the DiT, convert it and place it by the plan:
    {"model", "plan" (_plan's), "streamed" (StreamedNaDiT or None),
    "host_copy" (the phase offload's HostCopy or None), "gen_state" (the
    generator after the DiT's draws, for a cached DiT's VAE)}."""
    if dit_path is not None:
        model = read_dit_model(dit_path, "cpu", dtype, quant)
        model = quantize_dit_by_block(model, quant, dit_path.endswith(".gguf"),
                                      device, min_dim, align)
    else:
        model = _random_dit(dit_cfg, quant, device, dtype, gen,
                            blocks_to_swap, min_dim, align)
    plan = _plan(model, blocks_to_swap, device)
    out = {"model": model, "plan": plan, "streamed": None, "host_copy": None,
           "gen_state": gen.get_state() if gen is not None else None}
    if plan[0] == "stream":
        out["streamed"] = StreamedNaDiT(model, keep_blocks=plan[1],
                                        device=device)
    elif plan[0] == "offload":
        log.info("DiT weights large vs the card: engaging per-phase offload "
                 "(weights leave the card during the VAE phases)")
        out["host_copy"] = HostCopy(model, device)
    else:
        place(model, device)
    return out


def _plan(model: NaDiT, blocks_to_swap: int, device) -> tuple:
    """("stream", keep_blocks), ("offload",) or ("resident",): JAX's
    decision (_plan_block_streaming, then _PHASE_OFFLOAD_FRACTION)."""
    keep = _plan_block_streaming(model, blocks_to_swap, device)
    if keep is not None:
        return ("stream", keep)
    limit = _device_limit(device)
    if limit is not None and (_per_chip_dit_bytes(model, 1)
                              > _PHASE_OFFLOAD_FRACTION * limit):
        return ("offload",)
    return ("resident",)
