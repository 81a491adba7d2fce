"""3D window partition planning for NaDiT windowed attention.

Host-side numpy, copied unchanged from the JAX package
(seedvr2_tpu.models.dit.windows) and pinned equal to it by
tests/test_torch_configs.py. Original notes follow.

TPU-first redesign of the reference's varlen window machinery
(src/models/dit_3b/window.py:28-85 window slicing, na.py:583-641 index-based
partition): instead of packing heterogeneous windows into one varlen sequence
at runtime, we compute the full partition *at trace time* (host-side numpy),
group windows by identical shape, and bake static gather/scatter index arrays
into the jitted function. Each shape-group becomes one dense batched attention
call [num_windows, window_len, heads, head_dim] — an MXU-shaped problem with
no dynamic shapes.

Window sizing math matches the reference exactly: 720p-normalized target
window counts, ceil splits, 0.5-shift variant for alternating layers.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


def _window_extents(size, num_windows):
    """Per-axis uniform window extent (wt, wh, ww), reference math
    (window.py:28-49: 720p-normalized target counts, ceil splits)."""
    t, h, w = size
    nt_tgt, nh_tgt, nw_tgt = num_windows
    scale = math.sqrt((45 * 80) / (h * w))
    resized_h, resized_w = round(h * scale), round(w * scale)
    wh = math.ceil(resized_h / nh_tgt)
    ww = math.ceil(resized_w / nw_tgt)
    wt = math.ceil(min(t, 30) / nt_tgt)
    return wt, wh, ww


def window_slices(size: Tuple[int, int, int], num_windows: Tuple[int, int, int]):
    """Plain (non-shifted) 720p-normalized windows (window.py:28-49).

    Returns a list of (t_slice, h_slice, w_slice) covering `size` exactly.
    """
    t, h, w = size
    nt_tgt, nh_tgt, nw_tgt = num_windows
    scale = math.sqrt((45 * 80) / (h * w))
    resized_h, resized_w = round(h * scale), round(w * scale)
    wh = math.ceil(resized_h / nh_tgt)
    ww = math.ceil(resized_w / nw_tgt)
    wt = math.ceil(min(t, 30) / nt_tgt)
    nt, nh, nw = math.ceil(t / wt), math.ceil(h / wh), math.ceil(w / ww)
    return [
        (
            slice(it * wt, min((it + 1) * wt, t)),
            slice(ih * wh, min((ih + 1) * wh, h)),
            slice(iw * ww, min((iw + 1) * ww, w)),
        )
        for iw in range(nw)
        if min((iw + 1) * ww, w) > iw * ww
        for ih in range(nh)
        if min((ih + 1) * wh, h) > ih * wh
        for it in range(nt)
        if min((it + 1) * wt, t) > it * wt
    ]


def shifted_window_slices(size: Tuple[int, int, int],
                          num_windows: Tuple[int, int, int]):
    """Half-window-shifted variant (window.py:51-83)."""
    t, h, w = size
    nt_tgt, nh_tgt, nw_tgt = num_windows
    scale = math.sqrt((45 * 80) / (h * w))
    resized_h, resized_w = round(h * scale), round(w * scale)
    wh = math.ceil(resized_h / nh_tgt)
    ww = math.ceil(resized_w / nw_tgt)
    wt = math.ceil(min(t, 30) / nt_tgt)

    st = 0.5 if wt < t else 0
    sh = 0.5 if wh < h else 0
    sw = 0.5 if ww < w else 0
    nt = math.ceil((t - st) / wt)
    nh = math.ceil((h - sh) / wh)
    nw = math.ceil((w - sw) / ww)
    nt = nt + 1 if st > 0 else 1
    nh = nh + 1 if sh > 0 else 1
    nw = nw + 1 if sw > 0 else 1
    return [
        (
            slice(max(int((it - st) * wt), 0), min(int((it - st + 1) * wt), t)),
            slice(max(int((ih - sh) * wh), 0), min(int((ih - sh + 1) * wh), h)),
            slice(max(int((iw - sw) * ww), 0), min(int((iw - sw + 1) * ww), w)),
        )
        for iw in range(nw)
        if min(int((iw - sw + 1) * ww), w) > max(int((iw - sw) * ww), 0)
        for ih in range(nh)
        if min(int((ih - sh + 1) * wh), h) > max(int((ih - sh) * wh), 0)
        for it in range(nt)
        if min(int((it - st + 1) * wt), t) > max(int((it - st) * wt), 0)
    ]


WINDOW_FNS = {
    "window": window_slices,            # "720pwin_by_size_bysize"
    "shifted_window": shifted_window_slices,  # "720pswin_by_size_bysize"
}


@dataclass(frozen=True)
class GroupPlan:
    """All windows sharing one (wt, wh, ww) shape, as a gather index array."""

    shape: Tuple[int, int, int]
    idx: np.ndarray  # (num_windows, window_len) int32 flat token indices


@dataclass(frozen=True)
class LayerPlan:
    """Partition of the (T, H, W) token grid for one window method."""

    groups: Tuple[GroupPlan, ...]
    inv: np.ndarray  # (L,) int32: tokens[i] = concat(group outputs)[inv[i]]
    num_windows: int


def build_layer_plan(size: Tuple[int, int, int],
                     num_windows: Tuple[int, int, int],
                     method: str) -> LayerPlan:
    t, h, w = size
    L = t * h * w
    grid = np.arange(L, dtype=np.int64).reshape(t, h, w)
    slices = WINDOW_FNS[method](size, num_windows)

    by_shape: Dict[Tuple[int, int, int], List[np.ndarray]] = {}
    order: List[Tuple[Tuple[int, int, int], int]] = []  # (shape, index in group)
    for (ts, hs, ws) in slices:
        win = grid[ts, hs, ws]
        shape = win.shape
        by_shape.setdefault(shape, [])
        order.append((shape, len(by_shape[shape])))
        by_shape[shape].append(win.reshape(-1))

    groups = tuple(
        GroupPlan(shape=shape, idx=np.stack(wins).astype(np.int32))
        for shape, wins in by_shape.items()
    )
    concat_idx = np.concatenate([g.idx.reshape(-1) for g in groups])
    assert concat_idx.shape[0] == L, "windows must partition the token grid"
    inv = np.argsort(concat_idx).astype(np.int32)
    return LayerPlan(groups=groups, inv=inv, num_windows=len(slices))


# --------------------------------------------------------------------------
# Uniform padded partition (TPU fast path)
# --------------------------------------------------------------------------
#
# Observation: the reference's ragged windows are a *uniform* grid of extent
# w̄ per axis, offset by -ceil(w̄/2) on shifted layers, clipped to the token
# grid, with empty windows dropped. So padding each axis by
# (front = w̄ - first_width, back = n*w̄ - front - length) turns the
# partition into a pure reshape/transpose — no gathers — at the cost of a
# few pad tokens that are excluded from attention with a kv mask. Window
# membership and per-window softmax are then *identical* to the reference's
# (masked tokens never enter the softmax; padded query rows are cropped).


@dataclass(frozen=True)
class UniformPlan:
    """Uniform padded window partition of a (T, H, W) token grid."""

    size: Tuple[int, int, int]        # unpadded grid
    wshape: Tuple[int, int, int]      # uniform window extent (wt, wh, ww)
    nwin: Tuple[int, int, int]        # windows per axis (nt, nh, nw)
    pads: Tuple[Tuple[int, int], ...]  # per-axis (front, back) grid padding
    kv_valid: np.ndarray              # (num_windows, window_len) bool
    # per window, per axis: (real_len, slot_start) — the window's real token
    # extent and where it starts inside the padded window (slot_start > 0
    # only for front-clipped shifted windows; RoPE coords restart at 0 there)
    win_info: Tuple[Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]], ...]

    @property
    def num_windows(self) -> int:
        nt, nh, nw = self.nwin
        return nt * nh * nw

    @property
    def window_len(self) -> int:
        wt, wh, ww = self.wshape
        return wt * wh * ww


def _dim_spans(length: int, extent: int, shifted: bool) -> List[Tuple[int, int]]:
    """Per-axis window spans, mirroring window.py:28-83 for one axis."""
    if not shifted:
        n = math.ceil(length / extent)
        spans = [(i * extent, min((i + 1) * extent, length)) for i in range(n)]
    else:
        s = 0.5 if extent < length else 0
        n = math.ceil((length - s) / extent)
        n = n + 1 if s > 0 else 1
        spans = [
            (max(int((i - s) * extent), 0), min(int((i - s + 1) * extent), length))
            for i in range(n)
        ]
    return [(a, b) for a, b in spans if b > a]


def build_uniform_plan(size: Tuple[int, int, int],
                       num_windows: Tuple[int, int, int],
                       method: str) -> UniformPlan:
    extents = _window_extents(size, num_windows)
    shifted = method == "shifted_window"

    per_axis = []  # (n, front, back, spans)
    for L, wbar in zip(size, extents):
        spans = _dim_spans(L, wbar, shifted)
        n = len(spans)
        front = wbar - (spans[0][1] - spans[0][0]) if n > 1 else 0
        back = n * wbar - front - L
        assert 0 <= front < wbar and 0 <= back < wbar, (L, wbar, front, back)
        # uniform grid must reproduce the reference spans exactly
        for j, (a, b) in enumerate(spans):
            assert a == max(j * wbar - front, 0), (spans, front, j)
            assert b == min((j + 1) * wbar - front, L), (spans, front, j)
        per_axis.append((n, front, back, spans))

    nwin = tuple(ax[0] for ax in per_axis)
    pads = tuple((ax[1], ax[2]) for ax in per_axis)

    # per-axis slot validity per window: slot s is real iff
    # 0 <= j*wbar + s - front < L
    axis_valid = []
    axis_info = []
    for (n, front, _back, spans), wbar, L in zip(per_axis, extents, size):
        vs, infos = [], []
        for j in range(n):
            p = j * wbar + np.arange(wbar) - front
            vs.append((p >= 0) & (p < L))
            a, b = spans[j]
            infos.append((b - a, front if j == 0 else 0))
        axis_valid.append(vs)
        axis_info.append(infos)

    nt, nh, nw = nwin
    kv_valid = np.zeros((nt * nh * nw, int(np.prod(extents))), dtype=bool)
    win_info = []
    w = 0
    for jt in range(nt):
        for jh in range(nh):
            for jw in range(nw):
                v = (axis_valid[0][jt][:, None, None]
                     & axis_valid[1][jh][None, :, None]
                     & axis_valid[2][jw][None, None, :])
                kv_valid[w] = v.reshape(-1)
                win_info.append((axis_info[0][jt], axis_info[1][jh],
                                 axis_info[2][jw]))
                w += 1
    return UniformPlan(size=size, wshape=extents, nwin=nwin, pads=pads,
                       kv_valid=kv_valid, win_info=tuple(win_info))
