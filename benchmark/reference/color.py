"""The LAB colour fix, in float32: the output's high frequencies over the
input's low ones (five dilated 3x3 blurs), then the a* and b* channels
histogram-matched to the input's exactly (by sorting) and the lightness
blended 0.8 own / 0.2 matched. Frames (T, H, W, 3) in [-1, 1]."""

import torch
import torch.nn.functional as F

_KERNEL = ((0.0625, 0.125, 0.0625), (0.125, 0.25, 0.125),
           (0.0625, 0.125, 0.0625))


def _blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    h, w = img.shape[1:3]
    radius = min(radius, max(1, min(h, w) // 8))
    x = F.pad(img.permute(0, 3, 1, 2), (radius,) * 4, mode="replicate")
    out = torch.zeros_like(img)
    for i in range(3):
        for j in range(3):
            tap = x[:, :, i * radius:i * radius + h, j * radius:j * radius + w]
            out = out + _KERNEL[i][j] * tap.permute(0, 2, 3, 1)
    return out


def _bands(img: torch.Tensor, levels: int = 5):
    high = torch.zeros_like(img)
    low = img
    for i in range(levels):
        low = _blur(img, 2 ** i)
        high = high + img - low
        img = low
    return high, low


_RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
            (0.2126729, 0.7151522, 0.0721750),
            (0.0193339, 0.1191920, 0.9503041))
_XYZ2RGB = ((3.2404542, -1.5371385, -0.4985314),
            (-0.9692660, 1.8760108, 0.0415560),
            (0.0556434, -0.2040259, 1.0572252))
_EPS = 6.0 / 29.0
_KAPPA = (29.0 / 3.0) ** 3
_D65 = (0.95047, 1.0, 1.08883)


def _mat3(x, m):
    return torch.stack([x[..., 0] * r[0] + x[..., 1] * r[1] + x[..., 2] * r[2]
                        for r in m], dim=-1)


def _to_lab(rgb):
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    xyz = _mat3(lin, _RGB2XYZ) / torch.tensor(_D65, device=rgb.device)
    f = torch.where(xyz > _EPS ** 3, torch.sign(xyz) * xyz.abs() ** (1 / 3),
                    (xyz * _KAPPA + 16.0) / 116.0)
    return torch.stack([f[..., 1] * 116.0 - 16.0, (f[..., 0] - f[..., 1])
                        * 500.0, (f[..., 1] - f[..., 2]) * 200.0], dim=-1)


def _from_lab(lab):
    fy = (lab[..., 0] + 16.0) / 116.0
    fx = lab[..., 1] / 500.0 + fy
    fz = fy - lab[..., 2] / 200.0

    def inv(f):
        return torch.where(f > _EPS, f ** 3, (f * 116.0 - 16.0) / _KAPPA)

    xyz = torch.stack([inv(fx), inv(fy), inv(fz)], -1) * torch.tensor(
        _D65, device=lab.device)
    lin = _mat3(xyz, _XYZ2RGB)
    rgb = torch.where(lin > 0.0031308,
                      torch.clamp(lin, min=0.0) ** (1.0 / 2.4) * 1.055 - 0.055,
                      lin * 12.92)
    return torch.clamp(rgb, 0.0, 1.0)


def _match(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The k-th smallest of src becomes the k-th smallest of ref."""
    out = torch.empty_like(src.reshape(-1))
    out[torch.argsort(src.reshape(-1), stable=True)] = torch.sort(
        ref.reshape(-1), stable=True).values
    return out.reshape(src.shape)


def lab_color_transfer(content: torch.Tensor, style: torch.Tensor):
    c_high, _ = _bands(content.float())
    _, s_low = _bands(style.float())
    content = torch.clamp(c_high + s_low, -1.0, 1.0)
    c = _to_lab(torch.clamp((content + 1.0) * 0.5, 0.0, 1.0))
    s = _to_lab(torch.clamp((style.float() + 1.0) * 0.5, 0.0, 1.0))
    out_l = c[..., 0] * 0.8 + _match(c[..., 0], s[..., 0]) * 0.2
    out = _from_lab(torch.stack([out_l, _match(c[..., 1], s[..., 1]),
                                 _match(c[..., 2], s[..., 2])], dim=-1))
    return out * 2.0 - 1.0
