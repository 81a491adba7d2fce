"""Image/video preprocessing: short-side resize -> clamp -> DivisiblePad(16)
-> normalize to [-1, 1], on channels-last (T, H, W, C) fp32 frames in
[0, 1].

Port of seedvr2_tpu.utils.transforms. The resize is the same separable
bicubic-antialias interpolation matrix (host numpy), applied as two fp32
matmuls on the frames' device.
"""

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import spans


def side_resize_dims(h: int, w: int, size: int,
                     max_size: int = 0) -> Tuple[int, int]:
    """Target dims for short-side resize (SideResize semantics: int
    truncation for the long side, round() for the max-size rescale)."""
    short, long = (h, w) if h <= w else (w, h)
    new_short = size
    new_long = int(size * long / short)
    nh, nw = (new_short, new_long) if h <= w else (new_long, new_short)
    if max_size > 0 and max(nh, nw) > max_size:
        scale = max_size / max(nh, nw)
        nh, nw = round(nh * scale), round(nw * scale)
    return nh, nw


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic, a=-0.5 (PIL/torch antialiased-bicubic convention)."""
    ax = np.abs(x)
    w = np.where(ax <= 1.0, (a + 2) * ax**3 - (a + 3) * ax**2 + 1.0,
                 np.where(ax < 2.0,
                          a * (ax**3 - 5 * ax**2 + 8 * ax - 4.0), 0.0))
    return w


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bicubic antialias interpolation matrix (PIL-style window:
    edge pixels clamped by renormalizing over the valid support)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        idx = np.arange(lo, hi, dtype=np.float64)
        w = _cubic_kernel((idx + 0.5 - center) / fscale)
        s = w.sum()
        if s != 0:
            w = w / s
        m[i, lo:hi] = w
    return m


def resize_video(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bicubic antialiased resize of (T, H, W, C) frames, fp32 out."""
    h, w = x.shape[1], x.shape[2]
    x32 = x.float()
    if (h, w) == (nh, nw):
        return x32
    mh = spans.to_device(resize_matrix(h, nh), x.device)
    mw = spans.to_device(resize_matrix(w, nw), x.device)
    tmp = torch.einsum("oh,thwc->towc", mh, x32)
    return torch.einsum("pw,towc->topc", mw, tmp)


def divisible_pad(x: torch.Tensor, factor: int = 16) -> torch.Tensor:
    """Pad bottom/right with zeros to a multiple of `factor`."""
    h, w = x.shape[1], x.shape[2]
    ph = (factor - h % factor) % factor
    pw = (factor - w % factor) % factor
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, 0, pw, 0, ph))


def prepare_video(x: torch.Tensor, resolution: int, max_resolution: int = 0,
                  pad_factor: int = 16) -> torch.Tensor:
    """Full preprocessing: resize, clamp, pad, normalize to [-1, 1]."""
    h, w = x.shape[1], x.shape[2]
    nh, nw = side_resize_dims(h, w, resolution, max_resolution)
    out = torch.clamp(resize_video(x, nh, nw), 0.0, 1.0)
    out = divisible_pad(out, pad_factor)
    return out * 2.0 - 1.0


def compute_target_dims(h: int, w: int, resolution: int,
                        max_resolution: int = 0) -> Tuple[int, int]:
    """True output dims: resized dims rounded down to even."""
    nh, nw = side_resize_dims(h, w, resolution, max_resolution)
    return (nh // 2) * 2, (nw // 2) * 2

