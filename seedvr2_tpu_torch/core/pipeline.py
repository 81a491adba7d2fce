"""4-phase generation pipeline: encode-all -> upscale-all -> decode-all ->
postprocess-all.

Port of seedvr2_tpu.core.pipeline: frames (RGB or RGBA) live in host numpy,
each padded batch is moved to the device for its phase, latents stay on the
device between phases, and the output is assembled in one preallocated host
buffer with Hann-window temporal overlap blending. Batch index math matches
the JAX package (and the reference) exactly: step = batch_size -
temporal_overlap, optional uniform padding of the trailing batch, 4n+1
padding with reversed frames, per-batch `ori_length` trimming,
prepend-frame removal at the end. The phases take the JAX phases' options:
input and latent noise (seeded as utils/seed.py says), uniform batches,
progress and interrupt callbacks, alpha, every colour method and the
tile_debug overlay.

Under a mesh (runner.attach_mesh) every rank runs the same phases on the
same input, which it reads itself. The batches go in waves: the VAE phases'
waves hold one batch a rank of the mesh, the DiT phase's one a dp group
(of same-shape batches), and the runner spreads each wave and shares its
results with every rank in batch order (JAX's dp-sized waves; a short tail
wave leaves ranks idle where JAX pads it with copies of its last batch and
drops their results). Every draw is keyed by the batch index or the seed,
never by the rank, so the frames are those of one rank; every rank holds
them after decode and runs phase 4 on them; the caller writes them once.

Every phase is a span of utils/spans.py over ctx["timings"], the request
record: it records its wall time, ended by a device synchronise, and
`<phase>.host`, its seconds up to that synchronise, and runs inside a
profiler range `seedvr2.<phase>` that ends after that synchronise
(profile_requests attributes device time to phases by it). Inside a phase
the steps are spans of their own (`encode.prepare`, `decode.write`, ...,
the VAE's `*.vae.plan` / `tile` / `blend` / `slice`), and the copies
between host arrays and the device count their bytes (`h2d_bytes`,
`d2h_bytes`). The VAE phases release a phase-offloaded DiT at their entry
(runner.release_dit); phase 2 adds the seconds of its restore
("dit_restore") and, for a streamed DiT, the blocks' total stall
("dit_swap_stall") to the timings, and logs the BlockSwap summary.
"""

import logging
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..parallel.comm import wave_width
from ..utils import color_fix, spans, transforms
from ..utils.partition import partition_by_size
from ..utils.seed import input_noise_generator, noise_generator
from .alpha import process_alpha_for_batch
from .runner import VideoDiffusionRunner

log = logging.getLogger(__name__)

# ------------------------------------------------------------ temporal ops


def pad_video_temporal(video: np.ndarray, count: int = 0,
                       prepend: bool = False) -> np.ndarray:
    """Extend (T, H, W, C) video with reversed frames; count=0 means pad to
    the 4n+1 constraint."""
    t = video.shape[0]
    if count == 0 and not prepend:
        if t % 4 == 1:
            return video
        count = ((t - 1) // 4 + 1) * 4 + 1 - t
    if count <= 0:
        return video
    if count >= t:
        repeat_count = count - t + 1
        last = video[-1:]
        repeated = np.repeat(last, repeat_count, axis=0)
        reversed_frames = video[1:][::-1] if t > 1 else video[:0]
        parts = ([repeated, reversed_frames, video] if prepend
                 else [video, reversed_frames, repeated])
        return np.concatenate(parts, axis=0)
    if prepend:
        reversed_frames = video[1:count + 1][::-1]
        return np.concatenate([reversed_frames, video], axis=0)
    reversed_frames = video[-count - 1:-1][::-1]
    return np.concatenate([video, reversed_frames], axis=0)


def blend_overlapping_frames(prev_tail: np.ndarray, cur_head: np.ndarray,
                             overlap: int) -> np.ndarray:
    """Hann crossfade for overlap >= 3, linear otherwise."""
    if overlap >= 3:
        t = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
        u = np.clip((t - 1 / 3) / (1 / 3), 0.0, 1.0)
        w_prev = 0.5 + 0.5 * np.cos(np.pi * u)
    else:
        w_prev = np.linspace(1.0, 0.0, overlap, dtype=np.float32)
    w_prev = w_prev.reshape(overlap, 1, 1, 1)
    return prev_tail * w_prev + cur_head * (1.0 - w_prev)


def batch_indices(total_frames: int, batch_size: int, temporal_overlap: int):
    """(start, end) per batch with overlap semantics, and the overlap in
    effect."""
    step = batch_size - temporal_overlap if temporal_overlap > 0 else batch_size
    if step <= 0:
        step = batch_size
        temporal_overlap = 0
    out = []
    for idx in range(0, total_frames, step):
        if idx == 0:
            start, end = 0, min(batch_size, total_frames)
        else:
            start, end = idx, min(idx + batch_size, total_frames)
            if end - start <= temporal_overlap:
                break
        out.append((start, end))
    return out, temporal_overlap


def calculate_optimal_batch_params(total_frames, batch_size, temporal_overlap):
    step = batch_size - temporal_overlap
    if step <= 0:
        step, temporal_overlap = batch_size, 0
    valid = [i for i in range(1, total_frames + 1) if i % 4 == 1]
    return {"step": step, "temporal_overlap": temporal_overlap,
            "best_batch": max(valid) if valid else 1}


# ------------------------------------------------------------------ phases

# tile_debug: the phase whose tiles the overlay draws, and its colour
_TILE_DEBUG_COLOR = {"encode": (0.2, 1.0, 0.2), "decode": (1.0, 0.2, 0.2)}
TILE_DEBUG = ("false", *_TILE_DEBUG_COLOR)


def setup_generation_context(device, interrupt_fn: Optional[Callable] = None,
                             tile_debug: str = "false") -> Dict[str, Any]:
    """A request's context. interrupt_fn is called at the start of every
    batch of every phase and aborts the request by raising; tile_debug
    ("encode" or "decode") draws that phase's last tiles over the output."""
    if tile_debug not in TILE_DEBUG:
        raise ValueError(f"tile_debug must be one of {TILE_DEBUG}, got "
                         f"{tile_debug!r}")
    return {"device": torch.device(device), "interrupt_fn": interrupt_fn,
            "tile_debug": tile_debug, "text_embeds": None,
            "all_latents": [], "all_upscaled_latents": [],
            "final_video": None, "timings": {}}


def _check_interrupt(ctx: Dict[str, Any]) -> None:
    if ctx["interrupt_fn"] is not None:
        ctx["interrupt_fn"]()


@contextmanager
def _phase(ctx: Dict[str, Any], name: str):
    """One phase: the span `name` over the request record ctx["timings"],
    ended by a device synchronise, and `<name>.host`, its seconds up to
    that synchronise."""
    record = ctx["timings"]
    with spans.recording(record), spans.span(name):
        t0 = time.perf_counter()
        yield
        record[f"{name}.host"] = (record.get(f"{name}.host", 0.0)
                                  + time.perf_counter() - t0)
        if ctx["device"].type == "cuda":
            torch.cuda.synchronize(ctx["device"])


def _transform_batch(ctx: Dict[str, Any], rgb: np.ndarray) -> torch.Tensor:
    """Preprocess one padded batch: [0,1] THWC -> [-1,1] resized/padded."""
    with spans.span("upload"):
        x = spans.to_device(np.ascontiguousarray(rgb), ctx["device"],
                            torch.float32)
        return transforms.prepare_video(x, ctx["resolution"],
                                        ctx["max_resolution"])


def _wave_width(runner: VideoDiffusionRunner, axis: Optional[str]) -> int:
    """Batches a wave holds: the runner's spread over its mesh
    (parallel/comm.wave_width; axis None for the VAE phases, "dp" for the
    DiT phase)."""
    return wave_width(getattr(runner, "mesh", None), axis)


def _prepare_batch(images: np.ndarray, start: int, end: int,
                   uniform_padding: int) -> np.ndarray:
    video = images[start:end]
    if uniform_padding > 0:
        video = pad_video_temporal(video, count=uniform_padding)
    return pad_video_temporal(video)  # 4n+1


@torch.no_grad()
def encode_all_batches(runner: VideoDiffusionRunner, ctx: Dict[str, Any],
                       images: np.ndarray, batch_size: int = 5,
                       uniform_batch_size: bool = False, seed: int = 42,
                       progress_callback: Optional[Callable] = None,
                       temporal_overlap: int = 0, resolution: int = 1080,
                       max_resolution: int = 0,
                       input_noise_scale: float = 0.0,
                       input_noise_override: Optional[list] = None
                       ) -> Dict[str, Any]:
    """Phase 1: VAE-encode all batches. images: (T, H, W, 3 or 4) in
    [0, 1]; with 4 channels each padded batch's alpha is kept on the host
    for phase 4 and only the RGB is encoded.

    uniform_batch_size pads a short trailing batch to batch_size frames.
    input_noise_scale > 0 blends N(0, 1) * 0.05 noise into the transformed
    batch with weight scale / 2, drawn from input_noise_generator(seed, bi);
    input_noise_override replaces those per-batch N(0, 1) draws. The
    batches go in waves of one a rank of the mesh (runner.vae_encode
    spreads them; every rank prepares the wave's batches)."""
    if images.ndim != 4 or images.shape[-1] not in (3, 4):
        raise ValueError("the pipeline takes RGB or RGBA frames (T, H, W, 3 "
                         f"or 4); got {images.shape}")
    with _phase(ctx, "encode"):
        runner.release_dit()  # VAE phase: the device belongs to the encoder
        dev = ctx["device"]
        total = len(images)
        ctx.update(input_images=images, total_frames=total,
                   resolution=resolution, max_resolution=max_resolution,
                   is_rgba=images.shape[-1] == 4)
        ctx["true_target_dims"] = transforms.compute_target_dims(
            images.shape[1], images.shape[2], resolution, max_resolution)
        batches, actual_overlap = batch_indices(total, batch_size,
                                                temporal_overlap)
        ctx["actual_temporal_overlap"] = actual_overlap
        ctx.update(all_latents=[], all_ori_lengths=[], batch_metadata=[],
                   all_alpha_channels=[])
        for wave in partition_by_size(list(range(len(batches))),
                                      _wave_width(runner, None)):
            xs = []
            for bi in wave:
                _check_interrupt(ctx)
                with spans.span("prepare"):
                    start, end = batches[bi]
                    ori_length = end - start
                    uniform_pad = (batch_size - ori_length
                                   if uniform_batch_size
                                   and ori_length < batch_size else 0)
                    video = _prepare_batch(images, start, end, uniform_pad)
                    ctx["all_ori_lengths"].append(ori_length)
                    ctx["batch_metadata"].append((start, end, uniform_pad))
                    if ctx["is_rgba"]:
                        ctx["all_alpha_channels"].append(
                            video[..., 3:4].copy())
                        video = video[..., :3]
                x = _transform_batch(ctx, video)
                if input_noise_scale > 0:
                    if input_noise_override is not None:
                        noise = spans.to_device(input_noise_override[bi],
                                                dev, torch.float32)
                    else:
                        noise = torch.randn(
                            x.shape, generator=input_noise_generator(
                                seed, bi, dev),
                            dtype=torch.float32, device=dev)
                    blend = input_noise_scale * 0.5
                    x = x * (1 - blend) + (x + noise * 0.05) * blend
                xs.append(x.to(runner.compute_dtype))
            ctx["all_latents"] += runner.vae_encode(xs)
            ctx["encode_tile_boundaries"] = list(runner.vae.last_encode_tiles)
            if progress_callback:
                for bi in wave:
                    progress_callback(bi + 1, len(batches), ctx[
                        "all_ori_lengths"][bi], "Phase 1: Encoding")
    return ctx


@torch.no_grad()
def upscale_all_batches(runner: VideoDiffusionRunner, ctx: Dict[str, Any],
                        progress_callback: Optional[Callable] = None,
                        seed: int = 42, latent_noise_scale: float = 0.0,
                        noise_override: Optional[list] = None,
                        aug_noise_override: Optional[list] = None
                        ) -> Dict[str, Any]:
    """Phase 2: one-step DiT upscaling (cfg 1.0, one step), conditioned on
    ctx["text_embeds"] ({"pos", "neg"} arrays).

    Every batch's base noise is the first draw of noise_generator(seed), so
    every batch sees the same noise. latent_noise_scale > 0 moves the
    condition's latent along the schedule to the shifted timestep of
    1000 * scale, towards base * 0.1 + N(0, 1) * 0.05, N the generator's
    second draw. noise_override / aug_noise_override replace the base and
    the second draw with given per-batch arrays, so a test can feed the JAX
    pipeline and the port the same noise. Same-shape batches go in waves
    of one a dp group (runner.inference spreads them)."""
    restores = len(runner.restore_seconds)
    with _phase(ctx, "dit"):
        dev, dt = ctx["device"], runner.compute_dtype
        n = len(ctx["all_latents"])

        @spans.span("condition")
        def condition(bi):
            latent = ctx["all_latents"][bi]
            gen = noise_generator(seed, dev)
            # drawn even when overridden: the augmentation is the second draw
            base = torch.randn(latent.shape, generator=gen,
                               dtype=torch.float32, device=dev)
            if noise_override is not None:
                base = spans.to_device(noise_override[bi], dev, torch.float32)
            blurred = latent
            if latent_noise_scale > 0:
                if aug_noise_override is not None:
                    extra = spans.to_device(aug_noise_override[bi], dev,
                                            torch.float32)
                else:
                    extra = torch.randn(latent.shape, generator=gen,
                                        dtype=torch.float32, device=dev)
                aug = base * 0.1 + extra * 0.05
                t = runner.timestep_transform(
                    torch.tensor([1000.0 * latent_noise_scale]),
                    torch.tensor([latent.shape[:3]]))
                blurred = runner.schedule.forward(latent.float(), aug, t[0])
            noise = base.to(dt)
            return noise, runner.get_condition(noise, blurred.to(dt))

        groups: Dict[tuple, list] = {}
        for bi, latent in enumerate(ctx["all_latents"]):
            groups.setdefault(tuple(latent.shape), []).append(bi)
        results: list = [None] * n
        done = 0
        for idxs in groups.values():
            for wave in partition_by_size(idxs, _wave_width(runner, "dp")):
                _check_interrupt(ctx)
                noises, conds = zip(*(condition(bi) for bi in wave))
                with spans.span("forward"):
                    outs = runner.inference(
                        noises=list(noises), conditions=list(conds),
                        texts_pos=[ctx["text_embeds"]["pos"]],
                        texts_neg=[ctx["text_embeds"]["neg"]],
                        cfg_scale=1.0, steps=1)
                for bi, out in zip(wave, outs):
                    results[bi] = out
                    ctx["all_latents"][bi] = None
                done += len(wave)
                if progress_callback:
                    progress_callback(done, n, len(wave),
                                      "Phase 2: Upscaling")
        ctx["all_upscaled_latents"] = results
        ctx["all_latents"] = []
    if len(runner.restore_seconds) > restores:
        ctx["timings"]["dit_restore"] = sum(runner.restore_seconds[restores:])
    if runner.streamed_dit is not None:
        s = runner.streamed_dit.stats.summary()
        if s.get("total_swaps"):
            ctx["timings"]["dit_swap_stall"] = s["block_stall_total_ms"] / 1e3
            log.info("BlockSwap: %d swaps, stall avg %.1f ms / max %.1f ms "
                     "(one un-prefetched transfer = %.1f ms, %.0f MB/block)",
                     s["block_swaps"], s["block_avg_ms"], s["block_max_ms"],
                     s["measured_transfer_ms"], s["block_bytes"] / 1e6)
    return ctx


@torch.no_grad()
def decode_all_batches(runner: VideoDiffusionRunner, ctx: Dict[str, Any],
                       progress_callback: Optional[Callable] = None
                       ) -> Dict[str, Any]:
    """Phase 3: VAE decode into a preallocated host buffer (4 channels for
    RGBA, the alpha filled in phase 4) with overlap blending, in waves of
    one batch a rank of the mesh (runner.vae_decode spreads them)."""
    with _phase(ctx, "decode"):
        runner.release_dit()  # VAE phase: the device belongs to the decoder
        true_h, true_w = ctx["true_target_dims"]
        channels = 4 if ctx["is_rgba"] else 3
        with spans.span("alloc"):
            final = np.zeros((ctx["total_frames"], true_h, true_w, channels),
                             dtype=np.float32)
        overlap = ctx.get("actual_temporal_overlap", 0)
        write_idx = 0
        ctx["decode_batch_info"] = []
        n = len(ctx["all_upscaled_latents"])
        for wave in partition_by_size(list(range(n)),
                                      _wave_width(runner, None)):
            _check_interrupt(ctx)
            samples = runner.vae_decode(
                [ctx["all_upscaled_latents"][bi] for bi in wave])
            for bi, sample in zip(wave, samples):
                ori = ctx["all_ori_lengths"][bi]
                with spans.span("to_host"):
                    sample = spans.to_host(
                        sample[:ori, :true_h, :true_w].float())
                with spans.span("write"):
                    if bi > 0 and 0 < overlap < sample.shape[0] \
                            and write_idx >= overlap:
                        prev_tail = final[write_idx - overlap: write_idx, :,
                                          :, :3]
                        final[write_idx - overlap: write_idx, :, :, :3] = \
                            blend_overlapping_frames(
                                prev_tail, sample[:overlap], overlap)
                        sample = sample[overlap:]
                    end = write_idx + sample.shape[0]
                    final[write_idx:end, :, :, :3] = sample
                ctx["decode_batch_info"].append((write_idx, end, bi, ori))
                write_idx = end
                ctx["all_upscaled_latents"][bi] = None
                if progress_callback:
                    progress_callback(bi + 1, n, 1, "Phase 3: Decoding")
            del samples, sample  # the wave's device frames, before the next
        ctx["final_video"] = final[:write_idx]
        ctx["all_upscaled_latents"] = []
        ctx["decode_tile_boundaries"] = list(runner.vae.last_decode_tiles)
    return ctx


def draw_tile_boundaries(final: np.ndarray, tiles, color) -> None:
    """Draw each (y, x, h, w) rectangle's outline, cut at the frame, into
    the RGB channels of (T, H, W, C) frames in place."""
    for (y, x, h, w) in tiles:
        y2 = min(y + h, final.shape[1]) - 1
        x2 = min(x + w, final.shape[2]) - 1
        final[:, y:y2 + 1, [x, x2], :3] = color
        final[:, [y, y2], x:x2 + 1, :3] = color


@torch.no_grad()
def postprocess_all_batches(ctx: Dict[str, Any],
                            progress_callback: Optional[Callable] = None,
                            color_correction: str = "wavelet",
                            prepend_frames: int = 0) -> Dict[str, Any]:
    """Phase 4, per batch with one upload of its decoded RGB: the alpha of
    an RGBA request (edge-guided upscale of the batch's alpha, guided by the
    decoded RGB in [-1, 1], before the colour fix), colour correction
    against the re-transformed input RGB, [-1, 1] -> [0, 1]; then the
    tile_debug overlay and the prepend-frame trim."""
    with _phase(ctx, "postprocess"):
        dev = ctx["device"]
        final = ctx["final_video"]
        true_h, true_w = ctx["true_target_dims"]
        overlap = ctx.get("actual_temporal_overlap", 0)
        info = ctx["decode_batch_info"]
        for step, (ws, we, bi, _) in enumerate(info):
            _check_interrupt(ctx)
            with spans.span("upload"):
                sample = spans.to_device(final[ws:we, :, :, :3], dev)
            if ctx["is_rgba"]:
                with spans.span("alpha"):
                    alpha = spans.to_host(process_alpha_for_batch(
                        sample, ctx["all_alpha_channels"][bi])[:we - ws])
                with spans.span("write"):
                    final[ws:we, :, :, 3:4] = alpha
            if color_correction != "none":
                with spans.span("prepare"):
                    ref = _prepare_batch(ctx["input_images"],
                                         *ctx["batch_metadata"][bi])
                ref = _transform_batch(ctx, ref[..., :3])
                with spans.span("color"):
                    if bi > 0 and overlap > 0:
                        ref = ref[overlap:]
                    ref = ref[: sample.shape[0], :true_h, :true_w]
                    sample = color_fix.apply_color_correction(
                        color_correction, sample, ref)
            with spans.span("to_host"):
                out = spans.to_host(torch.clamp(sample, -1.0, 1.0) * 0.5
                                    + 0.5)
            with spans.span("write"):
                final[ws:we, :, :, :3] = out
            if progress_callback:
                progress_callback(step + 1, len(info), 1,
                                  "Phase 4: Post-processing")
        with spans.span("write"):
            tile_debug = ctx["tile_debug"]
            if tile_debug != "false":
                draw_tile_boundaries(
                    final, ctx.get(f"{tile_debug}_tile_boundaries") or [],
                    np.array(_TILE_DEBUG_COLOR[tile_debug], np.float32))
            if 0 < prepend_frames < final.shape[0]:
                final = final[prepend_frames:]
        ctx["final_video"] = final
    return ctx
