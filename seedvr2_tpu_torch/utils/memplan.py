"""Memory-aware VAE tile planning: `--vae_*_tile_size auto`.

Port of seedvr2_tpu.utils.memplan. The ladders and the candidate walk of
`plan_auto_tile` are the JAX package's, pinned equal by
tests/test_torch_memplan.py: the untiled candidate first (only while the
image is at most twice the top rung's area), then each ladder cap that
tiles the image, planned with the serving path's overlap clamp and cost
model and deduplicated by planned grid; the first candidate whose probe
bytes + orchestration overhead + safety margin fit the budget wins; if none
fits, the smallest rung is served and the runner's out-of-memory retry
takes it from there.

What differs is the probe. On the TPU, XLA's compile-only
`memory_analysis` tells a program's demand without running it; the card has
no such call, so `probe_tile_bytes` RUNS the port's `_encode_slices` /
`_decode_slices` once for one tile on the card, at the tile's shape and the
request's frame count, and reads the caching allocator's peak:
`torch.cuda.synchronize()`, `reset_peak_memory_stats()`, the run,
`synchronize()`, then `max_memory_allocated()` less what was allocated at
the start (the tile's input is made before the start, as the serving path
receives it). The run starts from an empty allocator cache, and the caching
allocator's fragmentation (what it reserved beyond that peak, measured
with little room to spare) is kept beside the bytes and added to the
candidate's margin: on the card it is not small (0.7-1.8 GiB over the
1080p clip's 10-30 GiB probes on an NVIDIA H100 80GB HBM3, 700 W;
PERF.md), where JAX's compile-time figures have none. The runner empties
the cache before an auto-planned call, so the call starts where its probe
did. A `torch.cuda.OutOfMemoryError` inside a probe is a verdict, "does
not fit": it is logged, the allocator's cache is emptied and the walk
goes on. Any other exception propagates: JAX serves a fixed 1024 px plan
when every probe fails, because a backend may lack `memory_analysis`; here
a failed probe is a fault of the port's own VAE and must not be hidden.

Probe results are cached in a JSON file keyed by a signature (the card's
name, the dtype, the VAE config fields JAX's `_vae_signature` lists, the
port's `Lowering` fields, the kind, the batch, the frames and the tile
shape): `~/.cache/seedvr2_tpu_torch/memprobe.json`, or the path in
`SEEDVR2_MEMPROBE_CACHE`. An out-of-memory verdict is kept beside it as a
lower bound (the room the run had), so a later plan with no more room
than that plus the tile's overhead and margin skips the tile without a
run. The write is atomic, and a failed write never fails the plan.
"""

import dataclasses
import json
import logging
import os
import threading
from typing import Dict, Optional, Tuple

import torch

log = logging.getLogger(__name__)

# Descending pixel-side caps (JAX's): the grid planner shapes tiles freely
# under cap^2, so adjacent rungs only need to plan different grids.
DECODE_LADDER = (1536, 1280, 1152, 1088, 1024, 896, 768, 640, 512, 384,
                 256)
ENCODE_LADDER = (2176, 1536, 1280, 1088, 1024, 896, 768, 640, 512, 384,
                 256)

# headroom for what a probe does not see: the served call's own start (its
# accumulator's segments, the allocator's cache state). JAX's 600 MB left
# the 1080p clip's planned decode ~0.4 GiB short of its reserved peak on an
# NVIDIA H100 80GB HBM3, 700 W (PERF.md), so 1.5 GiB; each probe's measured
# fragmentation is added on top (`fragmentation`)
_SAFETY_BYTES = 1536 << 20

_CACHE_LOCK = threading.Lock()
_CACHE_MEM: Optional[dict] = None  # in-process mirror of the JSON file

# probes run on the card in this process (cache hits are not counted)
probe_runs = 0


def _cache_path() -> str:
    return os.environ.get(
        "SEEDVR2_MEMPROBE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "seedvr2_tpu_torch",
                     "memprobe.json"))


def _load_cache() -> dict:
    global _CACHE_MEM
    if _CACHE_MEM is None:
        try:
            with open(_cache_path()) as f:
                _CACHE_MEM = json.load(f)
        except (OSError, ValueError):
            _CACHE_MEM = {}
    return _CACHE_MEM


def _store_entries(entries: Dict[str, int]) -> None:
    with _CACHE_LOCK:
        cache = _load_cache()
        cache.update(entries)
        path = _cache_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(cache, f, indent=0, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # the cache is an optimization; never fail the plan


def reset_cache_for_tests() -> None:
    global _CACHE_MEM
    with _CACHE_LOCK:
        _CACHE_MEM = None


def memory_limit(device) -> int:
    """Bytes the caching allocator may hold on `device`: the card's
    total_memory scaled by the per-process memory fraction. A device
    without an index ("cuda") is the current one."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * torch.cuda.get_per_process_memory_fraction(device))


def _vae_signature(vae) -> str:
    """The probed program's identity: the card, the dtype, JAX's config
    fields (the legacy switches included) and the port's Lowering."""
    cfg = vae.cfg
    dev = next(vae.model.parameters()).device
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    low = dataclasses.astuple(vae.lowering)
    return "|".join(str(x) for x in (
        kind, str(vae.dtype).replace("torch.", ""), cfg.block_out_channels,
        cfg.layers_per_block, cfg.latent_channels, cfg.norm_num_groups,
        cfg.conv_quant, cfg.mid_attention, cfg.use_quant_conv,
        cfg.use_post_quant_conv, cfg.time_receptive_field, low))


def probe_key(vae, kind: str, batch: int, frames: int, th_lat: int,
              tw_lat: int) -> str:
    return "|".join(str(x) for x in (
        _vae_signature(vae), kind, batch, frames, th_lat, tw_lat))


def _run_once(vae, kind: str, x: torch.Tensor, device) -> Tuple[int, int]:
    """One tile's encode/decode from an empty allocator cache: (allocated
    peak, reserved peak) in bytes above what was allocated / reserved at
    its start."""
    from ..models.vae.pipeline_vae import _decode_slices, _encode_slices

    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.memory_allocated(device)
    reserved = torch.cuda.memory_reserved(device)
    run = _decode_slices if kind == "decode" else _encode_slices
    out = run(vae.model, x, vae.lowering)
    torch.cuda.synchronize(device)
    del out
    return (int(torch.cuda.max_memory_allocated(device) - start),
            int(torch.cuda.max_memory_reserved(device) - reserved))


@torch.no_grad()
def probe_tile_bytes(vae, kind: str, batch: int, frames: int,
                     th_lat: int, tw_lat: int) -> int:
    """Device bytes one tile's encode/decode allocates at its peak, from a
    run on the card (cached). `frames` is pixel frames T for encode, latent
    frames Tl for decode; the tile is th_lat x tw_lat latent pixels. Raises
    torch.cuda.OutOfMemoryError when the tile does not fit; that verdict is
    cached as a lower bound of its bytes, the room the run had
    (`oom_bound`).

    The caching allocator's fragmentation is kept beside the bytes
    (`fragmentation`): what it reserved beyond the allocated peak. With
    room to spare it caches freed blocks rather than reuse them (31 GiB
    beyond the untiled 1080p decode's 30 GiB on the whole card), so where
    that exceeds a tenth of the bytes the tile is run again with only its
    bytes plus a tenth of room, and what it reserves then is kept (1.7 GiB
    for that decode); if that run runs out, the first figure stands. A
    process's first run also counts the CUDA libraries' workspaces that it
    allocates for good (a conservative figure)."""
    global probe_runs
    key = probe_key(vae, kind, batch, frames, th_lat, tw_lat)
    cache = _load_cache()
    if key in cache:
        return int(cache[key])
    cfg, sf = vae.cfg, vae.cfg.spatial_downsample_factor
    device = next(vae.model.parameters()).device
    if kind == "decode":
        shape = (batch, frames, th_lat, tw_lat, cfg.latent_channels)
    else:
        shape = (batch, frames, th_lat * sf, tw_lat * sf, 3)
    gen = torch.Generator(device).manual_seed(0)
    x = (torch.rand(shape, generator=gen, device=device) * 2 - 1).to(
        vae.dtype)
    limit = memory_limit(device)
    probe_runs += 1
    try:
        total, reserved = _run_once(vae, kind, x, device)
    except torch.cuda.OutOfMemoryError:
        total = None
    if total is None:
        # a verdict to keep: the tile needs more than the room it had (out
        # of the except block, the failed run's tensors are freed)
        torch.cuda.empty_cache()
        room = limit - torch.cuda.memory_reserved(device)
        _store_entries({f"{key}|oom": max(room, cache.get(f"{key}|oom",
                                                          room))})
        raise torch.cuda.OutOfMemoryError(
            f"memory probe: {kind} tile {th_lat}x{tw_lat} does not fit in "
            f"{room} bytes")
    gap = reserved - total
    if gap > total // 10:
        torch.cuda.empty_cache()
        tight = torch.cuda.memory_reserved(device) + total + total // 10
        if tight < limit:
            gap = min(gap, _pressed_gap(vae, kind, x, device, tight, total,
                                        limit))
    del x
    _store_entries({key: total, f"{key}|gap": max(0, gap)})
    return total


def _pressed_gap(vae, kind, x, device, tight: int, total: int,
                 limit: int) -> int:
    """The allocator's reserved bytes beyond `total` in a run under a memory
    fraction capped at `tight` bytes; a huge figure when it runs out."""
    card = torch.cuda.get_device_properties(device).total_memory
    torch.cuda.set_per_process_memory_fraction(tight / card, device)
    try:
        _, reserved = _run_once(vae, kind, x, device)
        gap = reserved - total
    except torch.cuda.OutOfMemoryError:
        gap = None
    finally:
        torch.cuda.set_per_process_memory_fraction(limit / card, device)
    torch.cuda.empty_cache()
    return limit if gap is None else gap


def fragmentation(vae, kind: str, batch: int, frames: int, th_lat: int,
                  tw_lat: int) -> int:
    """Bytes the caching allocator reserved beyond the allocated peak in
    this tile's probe (blocks it could not reuse), from the cache; 0
    when unknown."""
    return int(_load_cache().get(
        f"{probe_key(vae, kind, batch, frames, th_lat, tw_lat)}|gap", 0))


def oom_bound(vae, kind: str, batch: int, frames: int, th_lat: int,
              tw_lat: int) -> Optional[int]:
    """Bytes an out-of-memory probe of this tile showed it needs more than,
    from the cache; None when no probe of it ran out."""
    bound = _load_cache().get(
        f"{probe_key(vae, kind, batch, frames, th_lat, tw_lat)}|oom")
    return None if bound is None else int(bound)


def overhead_terms(kind: str, batch: int, frames_px: int, h_lat: int,
                   w_lat: int, th: int, tw: int, tl: int, sf: int, latc: int,
                   dtype) -> Dict[str, int]:
    """The port's tiled VideoVAE.encode / decode buffers outside one tile's
    run (exact shapes), by name. Where JAX's `_overhead_bytes` counts its
    scan path's stacked crops and, for encode, the resident pixel input, the
    port has neither (a tile's crop is a view, and the input is already
    allocated when the runner plans, so its budget has it counted);
    the port counts instead the fp32 copy of the finished tile and its
    masked product, alive beside the accumulator while it is added in, and
    the blend's fp32 mask and count planes on the device.
    Decode: "acc" the fp32 output accumulator, "normalized" its product
    with 1 / count, "result" the cast result (JAX's 2 acc + acc // 2 in
    bf16), "tile_f32" the two fp32 tiles, "mask" a tile's fade mask,
    "count" the 1 / count plane. Encode: "acc" the fp32 latent accumulator
    and "normalized" its quotient (JAX's 2 acc), "result" the cast latent,
    "tile_f32" the two fp32 latent tiles, "mask" and "count" as for
    decode at latent size. The terms are summed, though the tile terms and
    the last two whole-size ones are never alive together: a bound."""
    dt = torch.empty((), dtype=dtype).element_size()
    if kind == "decode":
        acc = batch * frames_px * h_lat * sf * w_lat * sf * 3 * 4
        tile = batch * frames_px * th * sf * tw * sf * 3 * 4
        mask, count = th * sf * tw * sf * 4, h_lat * sf * w_lat * sf * 4
    else:
        acc = batch * tl * h_lat * w_lat * latc * 4
        tile = batch * tl * th * tw * latc * 4
        mask, count = th * tw * 4, h_lat * w_lat * 4
    return {"acc": acc, "normalized": acc, "result": acc // 4 * dt,
            "tile_f32": 2 * tile, "mask": mask, "count": count}


def _overhead_bytes(kind: str, batch: int, frames_px: int, h_lat: int,
                    w_lat: int, n_tiles: int, th: int, tw: int, tl: int,
                    sf: int, latc: int, dtype) -> int:
    """Bytes of the tiled path's buffers outside the per-tile run (JAX's
    signature; `n_tiles` is unused: the port stacks no crops)."""
    return sum(overhead_terms(kind, batch, frames_px, h_lat, w_lat, th, tw,
                              tl, sf, latc, dtype).values())


def plan_auto_tile(vae, kind: str, lat_hw: Tuple[int, int], batch: int,
                   frames_px: int, overlap_px: Tuple[int, int],
                   budget_bytes: int, ladder=None
                   ) -> Optional[Tuple[int, int]]:
    """The largest tile cap (px) whose whole tiled call fits `budget_bytes`
    (the device bytes free for the call); None means untiled fits. `lat_hw`
    is the whole image in latent units, `frames_px` the pixel frame
    count. Falls back to the smallest rung when nothing fits."""
    from ..models.vae.pipeline_vae import _plan_grid

    cfg, sf = vae.cfg, vae.cfg.spatial_downsample_factor
    h, w = lat_hw
    tl = (frames_px - 1) // cfg.temporal_downsample_factor + 1
    if ladder is None:
        ladder = DECODE_LADDER if kind == "decode" else ENCODE_LADDER

    # candidates: untiled (only when the image is not far beyond the top
    # rung: probing a hopeless giant shape wastes a long run), then ladder
    # caps that tile the image, deduplicated by planned grid
    candidates = []  # (cap_px or None, n_tiles, th, tw)
    if h * w <= (ladder[0] // sf) ** 2 * 2:
        candidates.append((None, 1, h, w))
    seen = set()
    for cap in ladder:
        lt = max(1, cap // sf)
        if lt >= h and lt >= w:
            continue  # the same as untiled
        # the serving path's overlap clamp and cost model, so the verdict
        # is for the grid that executes
        ov = (max(0, min(overlap_px[0] // sf, lt - 1)),
              max(0, min(overlap_px[1] // sf, lt - 1)))
        ys, th, xs, tw = _plan_grid(
            h, w, lt * lt, *ov,
            cost="aspect" if kind == "decode" else "area")
        sig = (th, tw, len(ys), len(xs))
        if sig in seen:
            continue
        seen.add(sig)
        candidates.append((cap, len(ys) * len(xs), th, tw))

    frames = tl if kind == "decode" else frames_px
    for cap, n_tiles, th, tw in candidates:
        extra = 0 if cap is None else _overhead_bytes(
            kind, batch, frames_px, h, w, n_tiles, th, tw, tl, sf,
            cfg.latent_channels, vae.dtype)
        bound = oom_bound(vae, kind, batch, frames, th, tw)
        if bound is not None and bound + extra + _SAFETY_BYTES > budget_bytes:
            log.info("auto-tile %s: cap=%s grid=%d tiles of %dx%d (latent) "
                     "needs more than %.2f GB (an earlier probe ran out) -> "
                     "no", kind, cap, n_tiles, th, tw, bound / 1e9)
            continue
        try:
            tile_b = probe_tile_bytes(vae, kind, batch, frames, th, tw)
        except torch.cuda.OutOfMemoryError:
            tile_b = None
        if tile_b is None:
            # outside the except block the failed run's tensors are freed
            log.info("auto-tile %s: cap=%s grid=%d tiles of %dx%d (latent) "
                     "ran out of memory in its probe -> no", kind, cap,
                     n_tiles, th, tw)
            torch.cuda.empty_cache()
            continue
        total = tile_b + extra + _SAFETY_BYTES + fragmentation(
            vae, kind, batch, frames, th, tw)
        fits = total <= budget_bytes
        log.info("auto-tile %s: cap=%s grid=%d tiles of %dx%d (latent) "
                 "needs %.2f GB vs budget %.2f -> %s", kind, cap, n_tiles, th,
                 tw, total / 1e9, budget_bytes / 1e9,
                 "FITS" if fits else "no")
        if fits:
            return None if cap is None else (cap, cap)
    log.warning("auto-tile %s: nothing on the ladder fits %.2f GB; serving "
                "the smallest rung %d and relying on the out-of-memory "
                "retry", kind, budget_bytes / 1e9, ladder[-1])
    return (ladder[-1], ladder[-1])
