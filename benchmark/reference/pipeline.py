"""One SeedVR2 request, computed plainly in float32: resize and pad the
frames, encode, condition the noise on the latent, one Euler step of the
NaDiT from t = T to 0, decode, crop, the LAB colour fix against the input,
and the output transform to [0, 1].

Everything runs on the device of the inputs, with TF32 off; the caller
turns TF32 off for the process (`no_tf32`). Nothing here imports the
program.
"""

from contextlib import contextmanager

import numpy as np
import torch

from . import color, dit as ref_dit, geometry, vae as ref_vae
from .params import StateParams


@contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def pad_to_4n1(frames: np.ndarray) -> np.ndarray:
    """Extend a clip with its own frames, reversed, to 4n + 1 frames."""
    t = frames.shape[0]
    if t % 4 == 1:
        return frames
    count = ((t - 1) // 4 + 1) * 4 + 1 - t
    if count >= t:
        tail = np.concatenate([frames[1:][::-1] if t > 1 else frames[:0],
                               np.repeat(frames[-1:], count - t + 1, 0)])
    else:
        tail = frames[-count - 1:-1][::-1]
    return np.concatenate([frames, tail[:count]])


def prepare(frames: torch.Tensor, resolution: int) -> torch.Tensor:
    """(T, H, W, 3) in [0, 1] -> short side `resolution` (bicubic,
    antialiased), clamped, zero-padded to multiples of 16, in [-1, 1]."""
    h, w = frames.shape[1:3]
    nh, nw = geometry.side_resize_dims(h, w, resolution)
    x = frames.float()
    if (nh, nw) != (h, w):
        mh = torch.as_tensor(geometry.resize_matrix(h, nh),
                             dtype=torch.float32, device=frames.device)
        mw = torch.as_tensor(geometry.resize_matrix(w, nw),
                             dtype=torch.float32, device=frames.device)
        x = torch.einsum("pw,towc->topc", mw,
                         torch.einsum("oh,thwc->towc", mh, x))
    x = torch.clamp(x, 0.0, 1.0)
    ph, pw = (-nh) % 16, (-nw) % 16
    x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    return x * 2.0 - 1.0


def request(cfg: dict, traffic: dict, dit_state, vae_state,
            frames: np.ndarray, noise: torch.Tensor, txt: torch.Tensor,
            quant: str = "none") -> torch.Tensor:
    """The output frames (T, H', W', 3) in [0, 1] of one request whose
    frames form one batch. noise: the latent's diffusion noise (Tl, h, w,
    C); txt: the positive text embedding (Lt, txt_in_dim)."""
    vae, dcfg, lane = cfg["vae"], cfg["dit"], cfg["lane"]
    device = noise.device
    res = traffic["resolution"]
    t = frames.shape[0]
    if traffic["batch_size"] < t:
        raise ValueError("the reference serves a request of one batch")
    clip = torch.as_tensor(pad_to_4n1(frames), device=device)
    x = prepare(clip, res)
    vp = StateParams(vae_state)
    tiles = lane["vae_tiling"]
    if tiles["encode_tiled"]:
        lat = ref_vae.encode_tiled(vae, vp, x, tiles["encode_tile_size"],
                                   tiles["encode_tile_overlap"])
    else:
        lat = ref_vae.encode(vae, vp, x)
    lat = (lat - vae["shifting_factor"]) * vae["scaling_factor"]
    cond = torch.cat([lat, torch.ones_like(lat[..., :1])], dim=-1)
    v = ref_dit.nadit(dcfg, dit_state, torch.cat([noise, cond], dim=-1),
                      txt, 1000.0, quant)
    # v-prediction at t = T: x_0 = x_T - v
    z = (noise - v) / vae["scaling_factor"] + vae["shifting_factor"]
    if tiles["decode_tiled"]:
        out = ref_vae.decode_tiled(vae, vp, z, tiles["decode_tile_size"],
                                   tiles["decode_tile_overlap"])
    else:
        out = ref_vae.decode(vae, vp, z)
    th, tw = geometry.target_dims(frames.shape[1], frames.shape[2], res)
    out = out[:t, :th, :tw]
    if lane["color_correction"] == "lab":
        out = color.lab_color_transfer(out, x[:t, :th, :tw])
    elif lane["color_correction"] != "none":
        raise ValueError(f"the reference has no {lane['color_correction']!r}")
    return torch.clamp(out, -1.0, 1.0) * 0.5 + 0.5
