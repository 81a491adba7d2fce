"""Colour correction: lab, wavelet, wavelet_adaptive, hsv, adain and none.

Port of seedvr2_tpu.utils.color_fix. Tensors are channels-last video
(T, H, W, 3) in [-1, 1]; all math is fp32. The dilated blur is written as
nine shifted weighted adds and the colour-space matrices as explicit
channel sums, so no convolution or matmul can drop to TF32 on a GPU. The
HSV method's 1024-bin histograms are integer counts (an int32 `index_add_`,
no float atomics) summed in int64, so its CDFs equal the JAX package's
exactly while a bin holds fewer than 2^24 pixels.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

METHODS = ("lab", "wavelet", "wavelet_adaptive", "hsv", "adain", "none")


def adaptive_instance_normalization(content: torch.Tensor,
                                    style: torch.Tensor) -> torch.Tensor:
    """Per-frame, per-channel mean / std transfer (population variance,
    eps 1e-5 inside the square root, as jnp.var)."""
    def stats(x):
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=(1, 2), keepdim=True,
                                   correction=0)
        return mean, torch.sqrt(var + 1e-5)

    c_mean, c_std = stats(content)
    s_mean, s_std = stats(style)
    out = (content.float() - c_mean) / c_std * s_std + s_mean
    return out.to(content.dtype)

_KERNEL = ((0.0625, 0.125, 0.0625),
           (0.125, 0.25, 0.125),
           (0.0625, 0.125, 0.0625))


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilated 3x3 Gaussian-ish blur per channel with replicate padding.
    image: (T, H, W, C) fp32."""
    h, w = image.shape[1:3]
    radius = min(radius, max(1, min(h, w) // 8))
    x = image.permute(0, 3, 1, 2)
    x = F.pad(x, (radius, radius, radius, radius), mode="replicate")
    out = torch.zeros_like(image)
    for i in range(3):
        for j in range(3):
            tap = x[:, :, i * radius: i * radius + h, j * radius: j * radius + w]
            out = out + _KERNEL[i][j] * tap.permute(0, 2, 3, 1)
    return out


def wavelet_decomposition(image: torch.Tensor, levels: int = 5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    high = torch.zeros_like(image, dtype=torch.float32)
    img = image.float()
    low = img
    for i in range(levels):
        low = wavelet_blur(img, 2 ** i)
        high = high + img - low
        img = low
    return high, low


def wavelet_reconstruction(content: torch.Tensor,
                           style: torch.Tensor) -> torch.Tensor:
    """Content high frequencies + style low frequencies."""
    c_high, _ = wavelet_decomposition(content)
    _, s_low = wavelet_decomposition(style)
    return torch.clamp(c_high + s_low, -1.0, 1.0).to(content.dtype)


_RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
            (0.2126729, 0.7151522, 0.0721750),
            (0.0193339, 0.1191920, 0.9503041))
_XYZ2RGB = ((3.2404542, -1.5371385, -0.4985314),
            (-0.9692660, 1.8760108, 0.0415560),
            (0.0556434, -0.2040259, 1.0572252))
_EPS = 6.0 / 29.0
_KAPPA = (29.0 / 3.0) ** 3
_D65 = (0.95047, 1.0, 1.08883)


def _mat3(x: torch.Tensor, m) -> torch.Tensor:
    """x (..., 3) @ m^T as explicit fp32 channel sums."""
    return torch.stack([x[..., 0] * r[0] + x[..., 1] * r[1] + x[..., 2] * r[2]
                        for r in m], dim=-1)


def _rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) in [0, 1] -> LAB channels stacked on the last axis."""
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    xyz = _mat3(lin, _RGB2XYZ) / torch.tensor(_D65, device=rgb.device)
    f = torch.where(xyz > _EPS ** 3, torch.sign(xyz) * xyz.abs() ** (1 / 3),
                    (xyz * _KAPPA + 16.0) / 116.0)
    L = f[..., 1] * 116.0 - 16.0
    a = (f[..., 0] - f[..., 1]) * 500.0
    b = (f[..., 1] - f[..., 2]) * 200.0
    return torch.stack([L, a, b], dim=-1)


def _lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = a / 500.0 + fy
    fz = fy - b / 200.0

    def inv(f):
        return torch.where(f > _EPS, f ** 3, (f * 116.0 - 16.0) / _KAPPA)

    xyz = torch.stack([inv(fx), inv(fy), inv(fz)], dim=-1) * torch.tensor(
        _D65, device=lab.device)
    lin = _mat3(xyz, _XYZ2RGB)
    rgb = torch.where(lin > 0.0031308,
                      torch.clamp(lin, min=0.0) ** (1.0 / 2.4) * 1.055 - 0.055,
                      lin * 12.92)
    return torch.clamp(rgb, 0.0, 1.0)


_LUMINANCE_WEIGHT = 0.8  # share of the content's own L kept


def _histogram_match(source: torch.Tensor,
                     reference: torch.Tensor) -> torch.Tensor:
    """Exact sort-based CDF matching of two same-sized tensors: the k-th
    smallest source value becomes the k-th smallest reference value."""
    if source.shape != reference.shape:
        raise ValueError(f"histogram matching needs equal shapes, got "
                         f"{tuple(source.shape)} and {tuple(reference.shape)}")
    src = source.reshape(-1)
    out = torch.empty_like(src)
    out[torch.argsort(src, stable=True)] = torch.sort(
        reference.reshape(-1), stable=True).values
    return out.reshape(source.shape)


def lab_color_transfer(content: torch.Tensor,
                       style: torch.Tensor) -> torch.Tensor:
    """Wavelet base + LAB a*/b* histogram matching + weighted L.
    content/style: (T, H, W, 3) in [-1, 1], same shape."""
    content = wavelet_reconstruction(content, style).float()
    style = style.float()
    c01 = torch.clamp((content + 1.0) * 0.5, 0.0, 1.0)
    s01 = torch.clamp((style + 1.0) * 0.5, 0.0, 1.0)
    c_lab = _rgb_to_lab(c01)
    s_lab = _rgb_to_lab(s01)

    matched_a = _histogram_match(c_lab[..., 1], s_lab[..., 1])
    matched_b = _histogram_match(c_lab[..., 2], s_lab[..., 2])
    matched_l = _histogram_match(c_lab[..., 0], s_lab[..., 0])
    out_l = (c_lab[..., 0] * _LUMINANCE_WEIGHT
             + matched_l * (1.0 - _LUMINANCE_WEIGHT))
    out = _lab_to_rgb(torch.stack([out_l, matched_a, matched_b], dim=-1))
    return out * 2.0 - 1.0


# ------------------------------------------------------------------- hsv


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    rangec = maxc - minc
    live = rangec > 1e-10
    safe = torch.where(live, rangec, 1.0)
    # Python-style remainder, as jnp's `%`
    h = torch.where((maxc == r) & live, torch.remainder((g - b) / safe, 6.0),
                    torch.where((maxc == g) & live, (b - r) / safe + 2.0,
                                torch.where((maxc == b) & live,
                                            (r - g) / safe + 4.0, 0.0)))
    h = h / 6.0
    s = torch.where(maxc > 1e-10, rangec / torch.clamp(maxc, min=1e-10), 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.remainder(torch.floor(h).to(torch.int32), 6)
    f = h - torch.floor(h)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def select(*vals):  # jnp.select over i == 0 .. 5
        out = torch.zeros_like(v)
        for k in range(5, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, q, v)], dim=-1)


_NUM_HUE_BINS = 12
_NUM_CDF_BINS = 1024
_MIN_PIXELS = 100


def _cdf_bins(vals: torch.Tensor) -> torch.Tensor:
    """Each value's CDF bin on [0, 1] (int64, truncated as jnp's astype)."""
    return torch.clamp((vals * _NUM_CDF_BINS).to(torch.int32), 0,
                       _NUM_CDF_BINS - 1).reshape(-1).long()


def _masked_cdf(bins: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The 1024-bin CDF of the values whose mask is set: integer counts
    (masked-out values land in an overflow bin), an int64 cumulative sum,
    then one fp32 division by the clipped total, which rounds the exact
    integer quotient as JAX's fp32 sums of the same counts do."""
    key = torch.where(mask.reshape(-1), bins, _NUM_CDF_BINS)
    hist = torch.zeros(_NUM_CDF_BINS + 1, dtype=torch.int32,
                       device=bins.device)
    hist.index_add_(0, key, torch.ones((), dtype=torch.int32,
                                       device=bins.device).expand(key.shape))
    cum = torch.cumsum(hist[:_NUM_CDF_BINS].long(), 0)
    total = torch.clamp(cum[-1:], min=1)
    return cum.float() / total.float()


def _masked_cdf_match(src_bins: torch.Tensor, src_mask: torch.Tensor,
                      ref_bins: torch.Tensor, ref_mask: torch.Tensor
                      ) -> torch.Tensor:
    """Histogram-match the masked source values to the masked reference
    through binned CDFs: a value in source bin i maps to the centre of the
    first reference bin whose CDF reaches src_cdf[i]. Returns the 1024
    matched values, one per source bin (the JAX function evaluates the
    same lookup per pixel)."""
    src_cdf = _masked_cdf(src_bins, src_mask)
    ref_cdf = _masked_cdf(ref_bins, ref_mask)
    inv = torch.clamp(torch.searchsorted(ref_cdf, src_cdf), 0,
                      _NUM_CDF_BINS - 1)
    return (inv.float() + 0.5) / _NUM_CDF_BINS


def _hue_mask(h: torch.Tensor, b: int) -> torch.Tensor:
    bin_w = 1.0 / _NUM_HUE_BINS
    lo, hi = b * bin_w, (b + 1) * bin_w
    if b == 0:  # red wraps round: [0, hi) and [1 - bin_w, ...)
        return ((h >= 0) & (h < hi)) | (h >= 1.0 - bin_w)
    return (h >= lo) & (h < hi)


def hsv_saturation_histogram_match(content: torch.Tensor,
                                   style: torch.Tensor) -> torch.Tensor:
    """Hue-conditional saturation matching: 12 hue bins (bin 0 wraps round
    red, so it overlaps bin 11, which is applied after it), the saturation
    CDF matched per bin where both masks count more than 100 pixels, hue
    and value kept. One mask pair is alive at a time."""
    c01 = torch.clamp((content.float() + 1.0) * 0.5, 0.0, 1.0)
    s01 = torch.clamp((style.float() + 1.0) * 0.5, 0.0, 1.0)
    c_hsv = _rgb_to_hsv(c01)
    s_hsv = _rgb_to_hsv(s01)
    del c01, s01
    ch, cs, cv = c_hsv[..., 0], c_hsv[..., 1], c_hsv[..., 2]
    sh = s_hsv[..., 0]
    c_bins, s_bins = _cdf_bins(cs), _cdf_bins(s_hsv[..., 1])
    matched = cs
    for b in range(_NUM_HUE_BINS):
        c_mask, s_mask = _hue_mask(ch, b), _hue_mask(sh, b)
        enough = ((c_mask.sum() > _MIN_PIXELS)
                  & (s_mask.sum() > _MIN_PIXELS))
        lut = _masked_cdf_match(c_bins, c_mask, s_bins, s_mask)
        m = lut[c_bins].reshape(cs.shape)
        matched = torch.where(c_mask & enough, m, matched)
    out = _hsv_to_rgb(torch.stack([ch, matched, cv], dim=-1))
    out = torch.clamp(out, 0.0, 1.0) * 2.0 - 1.0
    return out.to(content.dtype)


# ------------------------------------------------------- wavelet adaptive


def _saturation_map(x: torch.Tensor) -> torch.Tensor:
    rgb = torch.clamp((x.float() + 1.0) * 0.5, 0.0, 1.0)
    maxc = rgb.amax(dim=-1, keepdim=True)
    minc = rgb.amin(dim=-1, keepdim=True)
    return torch.where(maxc > 1e-10,
                       (maxc - minc) / torch.clamp(maxc, min=1e-10), 0.0)


def wavelet_adaptive_color_correction(content: torch.Tensor,
                                      style: torch.Tensor) -> torch.Tensor:
    """Wavelet base, with the HSV correction blended in only where the
    content is oversaturated against the style and the wavelet base still
    is."""
    content32, style32 = content.float(), style.float()
    wave = wavelet_reconstruction(content32, style32).float()
    hsv = hsv_saturation_histogram_match(content32, style32).float()
    s_sat = _saturation_map(style32)
    threshold, sharpness = 0.15, 5.0
    blend = torch.sigmoid(sharpness * ((_saturation_map(content32) - s_sat)
                                       - threshold))
    still_over = ((_saturation_map(wave) - s_sat)
                  > threshold * 0.5).float()
    blend = torch.clamp(blend * still_over, 0.0, 1.0)
    out = wave * (1.0 - blend) + hsv * blend
    return out.to(content.dtype)


def apply_color_correction(method: str, sample: torch.Tensor,
                           reference: torch.Tensor) -> torch.Tensor:
    """Dispatch used by phase 4. sample/reference: (T, H, W, 3) in [-1, 1]."""
    if method == "lab":
        return lab_color_transfer(sample, reference)
    if method == "wavelet":
        return wavelet_reconstruction(sample, reference)
    if method == "wavelet_adaptive":
        return wavelet_adaptive_color_correction(sample, reference)
    if method == "hsv":
        return hsv_saturation_histogram_match(sample, reference)
    if method == "adain":
        return adaptive_instance_normalization(sample, reference)
    if method == "none":
        return sample
    raise ValueError(f"unknown colour correction {method!r}; the methods "
                     f"are {', '.join(METHODS)}")
