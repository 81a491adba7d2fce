"""Rectified-flow diffusion math: schedule, timesteps, Euler step, CFG, and
the trainer's logit-normal timesteps.

Port of seedvr2_tpu.core.diffusion. Timesteps are computed on the host with
numpy; the step math runs on tensors in fp32 islands.
"""

import numpy as np
import torch


def _f32(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


class LerpSchedule:
    """x_t = A(t) x_0 + B(t) x_T with A = 1 - t/T, B = t/T (continuous)."""

    def __init__(self, T: float = 1000.0):
        self.T = float(T)

    def A(self, t):
        return 1.0 - t / self.T

    def B(self, t):
        return t / self.T

    def forward(self, x_0: torch.Tensor, x_T: torch.Tensor, t) -> torch.Tensor:
        t = _f32(t, x_0)
        a = self.A(t).to(x_0.dtype)
        b = self.B(t).to(x_0.dtype)
        return a * x_0 + b * x_T

    def convert_from_pred(self, pred: torch.Tensor, pred_type: str,
                          x_t: torch.Tensor, t):
        """Return (pred_x_0, pred_x_T); v_lerp: v = x_T - x_0."""
        t = _f32(t, pred)
        a = self.A(t)
        b = self.B(t)
        p32 = pred.float()
        x32 = x_t.float()
        if pred_type == "v_lerp":
            denom = a + b
            x0 = (x32 - b * p32) / denom
            xT = (x32 + a * p32) / denom
        elif pred_type == "x_0":
            x0 = p32
            xT = (x32 - a * x0) / b
        elif pred_type == "x_T":
            xT = p32
            x0 = (x32 - b * xT) / a
        else:
            raise NotImplementedError(pred_type)
        return x0.to(pred.dtype), xT.to(pred.dtype)


def trailing_timesteps(T: float, steps: int, shift: float = 1.0) -> np.ndarray:
    """Uniform trailing timesteps in (0, T], descending; SD3 eq.23 shift."""
    t = np.arange(1.0, 0.0, -1.0 / steps, dtype=np.float64).astype(np.float32)
    t = shift * t / (1.0 + (shift - 1.0) * t)
    return (t * T).astype(np.float32)


def timestep_shift(timesteps: torch.Tensor, latent_shapes: torch.Tensor,
                   T: float = 1000.0, temporal_down: int = 4,
                   spatial_down: int = 8) -> torch.Tensor:
    """Resolution-dependent SD3-style timestep transform (image vs video
    linear shift functions of pixel count).

    Args:
        timesteps: (...,) timesteps in [0, T].
        latent_shapes: (..., 3) latent (t, h, w) per sample.
    """
    latent_shapes = torch.as_tensor(latent_shapes, dtype=torch.float32)
    frames = (latent_shapes[..., 0] - 1.0) * temporal_down + 1.0
    heights = latent_shapes[..., 1] * spatial_down
    widths = latent_shapes[..., 2] * spatial_down

    def lin(x1, y1, x2, y2, x):
        m = (y2 - y1) / (x2 - x1)
        return m * x + (y1 - m * x1)

    img_shift = lin(256.0 * 256.0, 1.0, 1024.0 * 1024.0, 3.2, heights * widths)
    vid_shift = lin(256.0 * 256.0 * 37.0, 1.0, 1280.0 * 720.0 * 145.0, 5.0,
                    heights * widths * frames)
    shift = torch.where(frames > 1.0, vid_shift, img_shift)

    t = torch.as_tensor(timesteps, dtype=torch.float32,
                        device=shift.device) / T
    t = shift * t / (1.0 + (shift - 1.0) * t)
    return t * T


def euler_step_to(schedule: LerpSchedule, pred: torch.Tensor,
                  x_t: torch.Tensor, t, s, pred_type: str = "v_lerp"):
    """One Euler step from x_t at t to x_s at s. Out-of-bound s is clamped to
    the endpoints: s < 0 -> x_0, s > T -> x_T."""
    T = schedule.T
    x0, xT = schedule.convert_from_pred(pred, pred_type, x_t, t)
    s_arr = _f32(s, pred)
    x_s = schedule.forward(x0, xT, torch.clamp(s_arr, 0.0, T))
    x_s = torch.where(s_arr >= 0.0, x_s, x0)
    x_s = torch.where(s_arr <= T, x_s, xT)
    return x_s


def classifier_free_guidance(pos: torch.Tensor, neg: torch.Tensor,
                             scale: float, rescale: float = 0.0):
    cfg = neg + scale * (pos - neg)
    if rescale != 0.0:
        dims = tuple(range(1, pos.ndim))
        pos_std = torch.std(pos, dim=dims, keepdim=True, correction=0)
        cfg_std = torch.std(cfg, dim=dims, keepdim=True, correction=0)
        factor = pos_std / cfg_std
        factor = rescale * factor + (1.0 - rescale)
        cfg = cfg * factor
    return cfg


def logitnormal_timesteps(generator: torch.Generator, shape, T: float = 1000.0,
                          loc: float = 0.0, scale: float = 1.0
                          ) -> torch.Tensor:
    """Training timesteps t = sigmoid(N(loc, scale)) * T in fp32 (the
    configs' diffusion.timesteps.training), drawn from `generator` on its
    device. Used by the training step (parallel/train.py)."""
    z = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale + loc
    return torch.sigmoid(z) * T
