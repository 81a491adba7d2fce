"""Colour correction, `lab` and `none` methods.

Port of seedvr2_tpu.utils.color_fix (lab_color_transfer and the wavelet
reconstruction it starts from). Tensors are channels-last video
(T, H, W, 3) in [-1, 1]; all math is fp32. The dilated blur is written as
nine shifted weighted adds and the colour-space matrices as explicit
channel sums, so no convolution or matmul can drop to TF32 on a GPU.
wavelet, wavelet_adaptive, hsv and adain wait for a later port.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

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


def apply_color_correction(method: str, sample: torch.Tensor,
                           reference: torch.Tensor) -> torch.Tensor:
    """Dispatch used by phase 4. sample/reference: (T, H, W, 3) in [-1, 1]."""
    if method == "lab":
        return lab_color_transfer(sample, reference)
    if method == "none":
        return sample
    raise ValueError(f"colour correction {method!r} is not ported yet "
                     "(ported: lab, none)")
