"""4-phase generation pipeline: encode-all -> upscale-all -> decode-all ->
postprocess-all.

Port of seedvr2_tpu.core.pipeline, RGB only, without a device mesh: frames
live in host numpy, each padded batch is moved to the device for its phase,
latents stay on the device between phases, and the output is assembled in
one preallocated host buffer with Hann-window temporal overlap blending.
Batch index math matches the JAX package (and the reference) exactly.

Every phase records its wall time, ended by a device synchronise, in
ctx["timings"].
"""

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import color_fix, transforms
from .runner import VideoDiffusionRunner

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


# ------------------------------------------------------------------ phases


def setup_generation_context(device) -> Dict[str, Any]:
    return {"device": torch.device(device), "text_embeds": None,
            "all_latents": [], "all_upscaled_latents": [],
            "final_video": None, "timings": {}}


@contextmanager
def _phase(ctx: Dict[str, Any], name: str):
    """Wall time of one phase, ended by a device synchronise."""
    t0 = time.perf_counter()
    yield
    if ctx["device"].type == "cuda":
        torch.cuda.synchronize(ctx["device"])
    ctx["timings"][name] = time.perf_counter() - t0


def _transform_batch(ctx: Dict[str, Any], rgb: np.ndarray) -> torch.Tensor:
    """Preprocess one padded batch: [0,1] THWC -> [-1,1] resized/padded."""
    x = torch.as_tensor(np.ascontiguousarray(rgb), dtype=torch.float32,
                        device=ctx["device"])
    return transforms.prepare_video(x, ctx["resolution"],
                                    ctx["max_resolution"])


def _prepare_batch(images: np.ndarray, start: int, end: int) -> np.ndarray:
    return pad_video_temporal(images[start:end])  # 4n+1


@torch.no_grad()
def encode_all_batches(runner: VideoDiffusionRunner, ctx: Dict[str, Any],
                       images: np.ndarray, batch_size: int = 5,
                       temporal_overlap: int = 0, resolution: int = 1080,
                       max_resolution: int = 0) -> Dict[str, Any]:
    """Phase 1: VAE-encode all batches. images: (T, H, W, 3) in [0, 1]."""
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError("the port's pipeline takes RGB frames (T, H, W, 3); "
                         f"got {images.shape}")
    with _phase(ctx, "encode"):
        total = len(images)
        ctx.update(input_images=images, total_frames=total,
                   resolution=resolution, max_resolution=max_resolution)
        ctx["true_target_dims"] = transforms.compute_target_dims(
            images.shape[1], images.shape[2], resolution, max_resolution)
        batches, actual_overlap = batch_indices(total, batch_size,
                                                temporal_overlap)
        ctx["actual_temporal_overlap"] = actual_overlap
        ctx["batches"] = batches
        ctx["all_latents"] = []
        for start, end in batches:
            x = _transform_batch(ctx, _prepare_batch(images, start, end))
            ctx["all_latents"].append(
                runner.vae_encode([x.to(runner.compute_dtype)])[0])
    return ctx


@torch.no_grad()
def upscale_all_batches(runner: VideoDiffusionRunner, ctx: Dict[str, Any],
                        seed: int = 42, noise_override: Optional[list] = None
                        ) -> Dict[str, Any]:
    """Phase 2: one-step DiT upscaling (cfg 1.0, one step), conditioned on
    ctx["text_embeds"] ({"pos", "neg"} arrays).

    The base noise of every batch comes from a torch.Generator seeded with
    `seed` (same seed -> same noise per batch, as in the reference);
    noise_override replaces it with given per-batch arrays, so a test can
    feed the JAX pipeline and the port the same noise."""
    with _phase(ctx, "dit"):
        dev, dt = ctx["device"], runner.compute_dtype
        results = []
        for bi, latent in enumerate(ctx["all_latents"]):
            if noise_override is not None:
                noise = torch.as_tensor(noise_override[bi],
                                        dtype=torch.float32, device=dev)
            else:
                gen = torch.Generator(dev).manual_seed(seed)
                noise = torch.randn(latent.shape, generator=gen,
                                    dtype=torch.float32, device=dev)
            noise = noise.to(dt)
            cond = runner.get_condition(noise, latent.to(dt))
            results.append(runner.inference(
                noises=[noise], conditions=[cond],
                texts_pos=[ctx["text_embeds"]["pos"]],
                texts_neg=[ctx["text_embeds"]["neg"]],
                cfg_scale=1.0, steps=1)[0])
            ctx["all_latents"][bi] = None
        ctx["all_upscaled_latents"] = results
        ctx["all_latents"] = []
    return ctx


@torch.no_grad()
def decode_all_batches(runner: VideoDiffusionRunner,
                       ctx: Dict[str, Any]) -> Dict[str, Any]:
    """Phase 3: VAE decode into a preallocated host buffer with overlap
    blending."""
    with _phase(ctx, "decode"):
        true_h, true_w = ctx["true_target_dims"]
        final = np.zeros((ctx["total_frames"], true_h, true_w, 3),
                         dtype=np.float32)
        overlap = ctx.get("actual_temporal_overlap", 0)
        write_idx = 0
        ctx["decode_batch_info"] = []
        for bi, latent in enumerate(ctx["all_upscaled_latents"]):
            lo, hi = ctx["batches"][bi]
            sample = runner.vae_decode([latent])[0][:hi - lo, :true_h, :true_w]
            sample = sample.float().cpu().numpy()
            if bi > 0 and 0 < overlap < sample.shape[0] \
                    and write_idx >= overlap:
                prev_tail = final[write_idx - overlap: write_idx]
                final[write_idx - overlap: write_idx] = \
                    blend_overlapping_frames(prev_tail, sample[:overlap],
                                             overlap)
                sample = sample[overlap:]
            end = write_idx + sample.shape[0]
            final[write_idx:end] = sample
            ctx["decode_batch_info"].append((write_idx, end, bi))
            write_idx = end
            ctx["all_upscaled_latents"][bi] = None
        ctx["final_video"] = final[:write_idx]
        ctx["all_upscaled_latents"] = []
    return ctx


@torch.no_grad()
def postprocess_all_batches(ctx: Dict[str, Any], color_correction: str = "lab",
                            prepend_frames: int = 0) -> Dict[str, Any]:
    """Phase 4: colour correction against the re-transformed input,
    [-1, 1] -> [0, 1]."""
    with _phase(ctx, "postprocess"):
        final = ctx["final_video"]
        true_h, true_w = ctx["true_target_dims"]
        overlap = ctx.get("actual_temporal_overlap", 0)
        for ws, we, bi in ctx["decode_batch_info"]:
            sample = final[ws:we]
            if color_correction != "none":
                ref = _transform_batch(ctx, _prepare_batch(
                    ctx["input_images"], *ctx["batches"][bi]))
                if bi > 0 and overlap > 0:
                    ref = ref[overlap:]
                ref = ref[: sample.shape[0], :true_h, :true_w]
                sample = color_fix.apply_color_correction(
                    color_correction, torch.as_tensor(sample,
                                                      device=ctx["device"]),
                    ref).cpu().numpy()
            final[ws:we] = np.clip(sample, -1.0, 1.0) * 0.5 + 0.5
        if 0 < prepend_frames < final.shape[0]:
            final = final[prepend_frames:]
        ctx["final_video"] = final
    return ctx
