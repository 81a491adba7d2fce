"""Rotary position embeddings for NaDiT, precomputed on the host.

The table functions are host-side numpy copied unchanged from the JAX package
(seedvr2_tpu.models.dit.rope) and pinned equal to it by
tests/test_torch_configs.py and tests/test_torch_uniform.py. The rotations
(`rotate_half_full`, `apply_rope_ext`, `apply_rope`) work on tensors.

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

from typing import Optional, Tuple

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


def embed_window_table(cos_r: np.ndarray, sin_r: np.ndarray,
                       wshape: Tuple[int, int, int],
                       win_info, head_dim: int, txt_len: int):
    """Embed a real sub-window's (rlen, rot) table into a padded uniform
    window (windows.py UniformPlan): real rows land at their padded slots
    (slot_start offsets for front-clipped shifted windows), identity rows
    (cos=1, sin=0) everywhere else: pad slots are masked kv / cropped q,
    and the trailing txt_len identity rows pass the appended text tokens
    through unrotated (3B text is rotated beforehand)."""
    wt, wh, ww = wshape
    wlen = wt * wh * ww
    cos_e = np.ones((wlen + txt_len, head_dim), np.float32)
    sin_e = np.zeros((wlen + txt_len, head_dim), np.float32)
    (rt, st), (rh, sh), (rw, sw) = win_info
    it = (st + np.arange(rt))[:, None, None]
    ih = (sh + np.arange(rh))[None, :, None]
    iw = (sw + np.arange(rw))[None, None, :]
    flat = ((it * wh + ih) * ww + iw).reshape(-1)
    rot = cos_r.shape[-1]
    cos_e[flat, :rot] = cos_r.reshape(len(flat), rot)
    sin_e[flat, :rot] = sin_r.reshape(len(flat), rot)
    return cos_e, sin_e


def rotate_half_full(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotate-half over the full last dim (must be even):
    (x[2i], x[2i+1]) -> (-x[2i+1], x[2i])."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).reshape(x.shape)


def apply_rope_ext(x: torch.Tensor, cos_e: torch.Tensor,
                   sin_e: torch.Tensor) -> torch.Tensor:
    """Full-width rotation with extended tables, in fp32, rounded back to
    x's dtype. x: (..., S, H, D); cos_e/sin_e: (..., S, D) fp32 (identity
    rows and dims pass through)."""
    x32 = x.float()
    c = cos_e.float()[..., :, None, :]
    s = sin_e.float()[..., :, None, :]
    return (x32 * c + rotate_half_full(x32) * s).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: Optional[torch.Tensor],
               sin: Optional[torch.Tensor]) -> torch.Tensor:
    """Rotate the leading rot_dim channels of x (..., S, heads, head_dim)
    with (S, rot_dim) fp32 tables; the remaining channels pass through."""
    if cos is None:
        return x
    rot = cos.shape[-1]
    x_rot = x[..., :rot].float()
    rotated = (x_rot * cos[..., :, None, :]
               + rotate_half_full(x_rot) * sin[..., :, None, :]).to(x.dtype)
    return torch.cat([rotated, x[..., rot:]], dim=-1)
