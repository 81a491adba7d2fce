"""Rotary position embeddings for NaDiT, precomputed on the host.

The table functions are host-side numpy copied unchanged from the JAX package
(seedvr2_tpu.models.dit.rope) and pinned equal to it by
tests/test_torch_configs.py. Only `rotate_half_full` touches tensors.

Two flavors:
 - 3B "mmrope3d": lang-style freqs (theta=10000), per-axis dim = rope_dim//3,
   video positions offset by the text length along the temporal axis
   (text occupies temporal slots [0, l), video [l, l+f)), text uses the 1D
   temporal table tiled x3.
 - 7B per-window "rope3d": pixel-style freqs (linspace(1, max_freq/2)*pi) with
   positions linspace(-1, 1, axis_len); no text rope, no offset.

Rotation is interleaved-pair (rotate_half on (d 2) pairs), applied to the
first `rot_dim` channels of each head; the remainder passes through.
"""

from typing import Tuple

import numpy as np
import torch


def _lang_freqs(dim_per_axis: int, theta: float = 10000.0) -> np.ndarray:
    exponents = np.arange(0, dim_per_axis, 2, dtype=np.float64)[: dim_per_axis // 2]
    return (1.0 / (theta ** (exponents / dim_per_axis))).astype(np.float64)


def _pixel_freqs(dim_per_axis: int, max_freq: float = 256.0) -> np.ndarray:
    n = dim_per_axis // 2
    return (np.linspace(1.0, max_freq / 2, n, dtype=np.float64) * np.pi)


def _axis_table(pos: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """(len,) positions x (n,) freqs -> (len, 2n) interleaved-duplicated."""
    table = np.outer(pos.astype(np.float64), freqs)
    return np.repeat(table, 2, axis=-1)


def _axial_concat(tables) -> np.ndarray:
    """Broadcast per-axis (d_i, f_i) tables over the grid and concat freqs."""
    dims = [t.shape[0] for t in tables]
    out = []
    for i, t in enumerate(tables):
        shape = [1] * len(dims) + [t.shape[-1]]
        shape[i] = dims[i]
        out.append(np.broadcast_to(t.reshape(shape), dims + [t.shape[-1]]))
    return np.concatenate(out, axis=-1)


def mmrope3d_video_table(window_shape: Tuple[int, int, int], txt_len: int,
                         rope_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """3B video cos/sin for one window shape, (window_len, rot_dim) fp32."""
    f, h, w = window_shape
    per_axis = rope_dim // 3
    freqs = _lang_freqs(per_axis)
    t_tab = _axis_table(np.arange(txt_len, txt_len + f), freqs)
    h_tab = _axis_table(np.arange(h), freqs)
    w_tab = _axis_table(np.arange(w), freqs)
    full = _axial_concat([t_tab, h_tab, w_tab]).reshape(f * h * w, -1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def mmrope3d_text_table(txt_len: int, rope_dim: int):
    """3B text cos/sin: 1D temporal table tiled x3."""
    per_axis = rope_dim // 3
    freqs = _lang_freqs(per_axis)
    tab = _axis_table(np.arange(txt_len), freqs)
    full = np.tile(tab, (1, 3))
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def rope3d_pixel_table(window_shape: Tuple[int, int, int], rope_dim: int,
                       max_freq: float = 256.0):
    """7B per-window cos/sin, positions linspace(-1, 1) per axis."""
    per_axis = rope_dim // 3

    def pos(n):
        return np.linspace(-1.0, 1.0, n) if n > 1 else np.zeros((1,)) - 1.0

    freqs = _pixel_freqs(per_axis, max_freq)
    tabs = [_axis_table(pos(d), freqs) for d in window_shape]
    full = _axial_concat(tabs).reshape(int(np.prod(window_shape)), -1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def extend_tables(cos: np.ndarray, sin: np.ndarray, head_dim: int,
                  extra_rows: int = 0):
    """Extend (S, rot) tables to (S + extra_rows, head_dim) with identity
    (cos=1, sin=0) in the padded dims/rows, so one full-width rotation ropes
    video tokens and passes text/pad tokens through."""
    s, rot = cos.shape
    cos_e = np.ones((s + extra_rows, head_dim), np.float32)
    sin_e = np.zeros((s + extra_rows, head_dim), np.float32)
    cos_e[:s, :rot] = cos
    sin_e[:s, :rot] = sin
    return cos_e, sin_e


def rotate_half_full(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotate-half over the full last dim (must be even):
    (x[2i], x[2i+1]) -> (-x[2i+1], x[2i])."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).reshape(x.shape)
