"""The general generator of a traffic mix: a pool of distinct inputs, each
with its diffusion noise, and the text embedding, all made from the run's
seed, and the closed loop that a mix's parameters describe.

A mix is a data file, `benchmark/workloads/<traffic>.json`:

    {"frames": 5, "height": 540, "width": 960,   # one request's input clip
     "resolution": 1080, "batch_size": 5,          # the CLI's target, batch
     "pool": 4,                 # distinct inputs, cycled through in order
     "loop": "closed", "clients": 1,   # one request at a time
     "check_requests": 2,       # requests of the window held to the reference
     "txt_len": 58, "neg_len": 64,   # text embedding lengths
     "why": "..."}

The frames are smooth colour gradients plus noise in [0, 1] (the pattern
the program's own profiler feeds). The noise and the text are drawn on the
device and rounded to bfloat16 once, so the program (which serves them in
bf16) and the float32 reference read the same values.
"""

import json
from pathlib import Path
from typing import List

import numpy as np
import torch

from .reference import geometry

WORKLOADS = Path(__file__).resolve().parent / "workloads"


def key(seed: int, *ids: int) -> list:
    """Entropy for one use of the run's seed (any whole number)."""
    return [seed % (1 << 64), *ids]


def load(traffic: str) -> dict:
    with open(WORKLOADS / f"{traffic}.json") as f:
        return json.load(f)


def make_frames(t: int, h: int, w: int, seed) -> np.ndarray:
    """Smooth colour gradients plus noise in [0, 1], (t, h, w, 3) float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([yy, xx, 1 - 0.5 * (yy + xx)], -1)[None]
    frames = base + 0.05 * rng.standard_normal((t, h, w, 3))
    return np.clip(frames, 0, 1).astype(np.float32)


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on `device` for one use (`stream`) of the run's seed."""
    mixed = np.random.SeedSequence(key(seed, stream))
    return torch.Generator(device).manual_seed(
        int(mixed.generate_state(1, np.uint64)[0]) >> 1)


def latent_shape(mix: dict, vae: dict):
    """(Tl, h, w, C) of one request's latent."""
    t = mix["frames"] + (-(mix["frames"] - 1)) % 4
    ph, pw = geometry.padded_dims(mix["height"], mix["width"],
                                  mix["resolution"])
    sf = vae["spatial_downsample_factor"]
    return ((t - 1) // vae["temporal_downsample_factor"] + 1, ph // sf,
            pw // sf, vae["latent_channels"])


class Pool:
    """The mix's distinct inputs: frames (host, float32), their noise and
    the text embeddings (device, bf16-exact float32)."""

    def __init__(self, mix: dict, vae: dict, txt_dim: int, seed: int, device):
        if mix["batch_size"] < mix["frames"]:
            raise ValueError("a request of the mix is one batch")
        if (mix["loop"], mix["clients"]) != ("closed", 1):
            raise ValueError("the generator drives one client in a closed "
                             "loop")
        self.mix = mix
        self.frames: List[np.ndarray] = [
            make_frames(mix["frames"], mix["height"], mix["width"],
                        key(seed, 1, i))
            for i in range(mix["pool"])]
        g = generator(device, seed, 2)
        shape = latent_shape(mix, vae)
        noise = torch.randn((mix["pool"], *shape), generator=g,
                            device=device).bfloat16().float()
        self.noise = list(noise.unbind(0))
        g = generator(device, seed, 3)
        self.txt = {k: torch.randn((n, txt_dim), generator=g, device=device)
                    .bfloat16().float()
                    for k, n in (("pos", mix["txt_len"]),
                                 ("neg", mix["neg_len"]))}

    def __len__(self):
        return len(self.frames)


def check_sample(n_requests: int, k: int, seed: int) -> List[int]:
    """k of the window's request indices, drawn from the seed, the last one
    among them (it ran past the deadline)."""
    rng = np.random.default_rng(key(seed, 4))
    if n_requests <= k:
        return list(range(n_requests))
    rest = rng.choice(n_requests - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in rest) + [n_requests - 1]
