"""Host-side geometry of a SeedVR2 request, in numpy: the short-side
bicubic resize, the NaDiT's 720p-normalised windows and rotary tables, and
the VAE's uniform tile grid with its cosine fades.

A frozen copy of the published arithmetic (SeedVR2's window.py, rope, the
SideResize / DivisiblePad transforms and the uniform tiled VAE), written
for this benchmark's plain reference; it imports nothing of the program.
"""

import math
from typing import List, Tuple

import numpy as np

# ------------------------------------------------------------------ resize


def side_resize_dims(h: int, w: int, size: int,
                     max_size: int = 0) -> Tuple[int, int]:
    """Short side to `size`, the long side truncated (SideResize)."""
    short, long = (h, w) if h <= w else (w, h)
    new_long = int(size * long / short)
    nh, nw = (size, new_long) if h <= w else (new_long, size)
    if max_size > 0 and max(nh, nw) > max_size:
        scale = max_size / max(nh, nw)
        nh, nw = round(nh * scale), round(nw * scale)
    return nh, nw


def padded_dims(h: int, w: int, size: int, factor: int = 16):
    """The resized frame's dims after padding to a multiple of `factor`."""
    nh, nw = side_resize_dims(h, w, size)
    return nh + (-nh) % factor, nw + (-nw) % factor


def target_dims(h: int, w: int, size: int) -> Tuple[int, int]:
    """The output frame's dims: the resized dims rounded down to even."""
    nh, nw = side_resize_dims(h, w, size)
    return nh // 2 * 2, nw // 2 * 2


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax <= 1.0, (a + 2) * ax**3 - (a + 3) * ax**2 + 1.0,
                    np.where(ax < 2.0, a * (ax**3 - 5 * ax**2 + 8 * ax - 4.0),
                             0.0))


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) antialiased bicubic weights, PIL's window renormalised over
    the valid support at the edges."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        idx = np.arange(lo, hi, dtype=np.float64)
        wgt = _cubic((idx + 0.5 - center) / fscale)
        if wgt.sum() != 0:
            wgt = wgt / wgt.sum()
        m[i, lo:hi] = wgt
    return m

# ----------------------------------------------------------------- windows


def _extents(size, num_windows):
    t, h, w = size
    nt, nh, nw = num_windows
    scale = math.sqrt((45 * 80) / (h * w))
    rh, rw = round(h * scale), round(w * scale)
    return math.ceil(min(t, 30) / nt), math.ceil(rh / nh), math.ceil(rw / nw)


def window_slices(size, num_windows):
    """The plain 720p-normalised windows covering the (T, H, W) grid."""
    t, h, w = size
    wt, wh, ww = _extents(size, num_windows)
    nt, nh, nw = math.ceil(t / wt), math.ceil(h / wh), math.ceil(w / ww)
    return [(slice(it * wt, min((it + 1) * wt, t)),
             slice(ih * wh, min((ih + 1) * wh, h)),
             slice(iw * ww, min((iw + 1) * ww, w)))
            for iw in range(nw) if min((iw + 1) * ww, w) > iw * ww
            for ih in range(nh) if min((ih + 1) * wh, h) > ih * wh
            for it in range(nt) if min((it + 1) * wt, t) > it * wt]


def shifted_window_slices(size, num_windows):
    """The half-window-shifted variant of the odd blocks."""
    t, h, w = size
    wt, wh, ww = _extents(size, num_windows)
    st = 0.5 if wt < t else 0
    sh = 0.5 if wh < h else 0
    sw = 0.5 if ww < w else 0
    nt = math.ceil((t - st) / wt) + 1 if st > 0 else 1
    nh = math.ceil((h - sh) / wh) + 1 if sh > 0 else 1
    nw = math.ceil((w - sw) / ww) + 1 if sw > 0 else 1

    def span(i, s, e, n):
        return max(int((i - s) * e), 0), min(int((i - s + 1) * e), n)

    out = []
    for iw in range(nw):
        a_w, b_w = span(iw, sw, ww, w)
        if b_w <= a_w:
            continue
        for ih in range(nh):
            a_h, b_h = span(ih, sh, wh, h)
            if b_h <= a_h:
                continue
            for it in range(nt):
                a_t, b_t = span(it, st, wt, t)
                if b_t > a_t:
                    out.append((slice(a_t, b_t), slice(a_h, b_h),
                                slice(a_w, b_w)))
    return out


def window_groups(size, num_windows, shifted: bool):
    """[(window shape, (n, wlen) token indices)] of one block's windows,
    grouped by shape, and the number of windows. Token index = (t*H + h)*W
    + w, each window's tokens in (t, h, w) raster order."""
    grid = np.arange(int(np.prod(size))).reshape(size)
    fn = shifted_window_slices if shifted else window_slices
    slices = fn(size, num_windows)
    groups = {}
    for sl in slices:
        win = grid[sl]
        groups.setdefault(win.shape, []).append(win.reshape(-1))
    return [(s, np.stack(v)) for s, v in groups.items()], len(slices)

# -------------------------------------------------------------------- rope


def _lang_freqs(dim: int, theta: float = 10000.0) -> np.ndarray:
    e = np.arange(0, dim, 2, dtype=np.float64)[: dim // 2]
    return 1.0 / (theta ** (e / dim))


def _axis(pos: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    return np.repeat(np.outer(pos.astype(np.float64), freqs), 2, axis=-1)


def _axial(tables) -> np.ndarray:
    dims = [t.shape[0] for t in tables]
    out = []
    for i, t in enumerate(tables):
        shape = [1] * len(dims) + [t.shape[-1]]
        shape[i] = dims[i]
        out.append(np.broadcast_to(t.reshape(shape), dims + [t.shape[-1]]))
    return np.concatenate(out, axis=-1).reshape(int(np.prod(dims)), -1)


def video_angles(rope_type: str, shape, txt_len: int,
                 rope_dim: int) -> np.ndarray:
    """(wlen, rot) rotary angles of one window's tokens: the 3B's mmrope3d
    (language frequencies, time offset by the text length) or the 7B's
    per-window rope3d (pixel frequencies over linspace(-1, 1))."""
    per_axis = rope_dim // 3
    if rope_type == "mmrope3d":
        f = _lang_freqs(per_axis)
        t, h, w = shape
        return _axial([_axis(np.arange(txt_len, txt_len + t), f),
                       _axis(np.arange(h), f), _axis(np.arange(w), f)])
    if rope_type == "rope3d_window":
        f = np.linspace(1.0, 128.0, per_axis // 2) * np.pi

        def pos(n):
            return np.linspace(-1.0, 1.0, n) if n > 1 else np.array([-1.0])

        return _axial([_axis(pos(n), f) for n in shape])
    raise ValueError(f"unknown rope type {rope_type!r}")


def text_angles(rope_type: str, txt_len: int, rope_dim: int):
    """(txt_len, rot) angles of the text tokens (the 3B's 1-D temporal table
    tiled three times), or None where the text is not rotated (7B)."""
    if rope_type != "mmrope3d":
        return None
    tab = _axis(np.arange(txt_len), _lang_freqs(rope_dim // 3))
    return np.tile(tab, (1, 3))

# -------------------------------------------------------------- VAE tiles


def _cos_ramp(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(np.linspace(0.0, 1.0, n) * np.pi)


def fade(length: int, overlap: int, at_start: bool, at_end: bool):
    """One tile side's separable blending weights."""
    wgt = np.ones((length,))
    ov = max(0, min(overlap, length - 1))
    if ov > 0:
        ramp = _cos_ramp(overlap)[:ov]
        if at_start:
            wgt[:ov] = ramp
        if at_end:
            wgt[-ov:] = 1.0 - ramp
    return wgt


def _even_starts(total: int, tile: int, n: int) -> List[int]:
    if n == 1:
        return [0]
    return [round(i * (total - tile) / (n - 1)) for i in range(n)]


def min_overlap(starts, tile: int) -> int:
    if len(starts) < 2:
        return 0
    return min(starts[i] + tile - starts[i + 1]
               for i in range(len(starts) - 1))


def plan_grid(h: int, w: int, cap_area: int, ov_h: int, ov_w: int,
              cost: str = "area"):
    """The uniform grid of same-shape tiles over an h x w latent: tiles of
    area <= cap_area overlapping by >= (ov_h, ov_w), evenly spaced, the one
    with least total area ("area") or least modelled decode time
    ("aspect"). Returns (ys, th, xs, tw)."""
    best = None
    for nr in range(1, min(h, 64) + 1):
        th = min(h, math.ceil((h + (nr - 1) * ov_h) / nr))
        if nr > 1 and th <= ov_h:
            break
        found = None
        for nc in range(1, min(w, 64) + 1):
            tw = min(w, math.ceil((w + (nc - 1) * ov_w) / nc))
            if nc > 1 and tw <= ov_w:
                break
            if th * tw <= cap_area:
                found = (nc, tw)
                break
        if found is None:
            continue
        nc, tw = found
        n = nr * nc
        c = (n * (float(th) * tw * (th + 250) + 600_000.0) if cost == "aspect"
             else float(n * th * tw))
        if best is None or c < best[0]:
            best = (c, nr, nc, th, tw)
    if best is None:
        return [0], h, [0], w
    _, nr, nc, th, tw = best
    return _even_starts(h, th, nr), th, _even_starts(w, tw, nc), tw
