"""Edge-guided alpha channel upscaling (RGBA inputs).

Port of seedvr2_tpu.core.alpha: Sobel edge detection, box-filter guided
filter (zero padding, counted in the mean), bicubic base upscale and the
binary-mask refinement cascade. Channels-last (T, H, W, C) fp32 tensors on
any device. The Sobel taps and the grey mix are shifted weighted adds, the
box filter is `avg_pool2d` and the 3x3 max window `max_pool2d`, so no
convolution or matmul can drop to TF32 on a GPU. The two host decisions
(the input's value range, the binary-vs-gradient path) are taken once per
batch.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import spans
from ..utils.transforms import resize_video

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = tuple(zip(*_SOBEL_X))
_GRAY = (0.299, 0.587, 0.114)


def _conv3x3_reflect(x: torch.Tensor, kernel) -> torch.Tensor:
    """3x3 cross-correlation of (T, H, W) with a reflect-101 border (cv2),
    as nine shifted weighted adds."""
    h, w = x.shape[1:]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    out = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            if kernel[i][j]:
                out = out + kernel[i][j] * xp[:, i:i + h, j:j + w]
    return out


def detect_edges(rgb01: torch.Tensor) -> torch.Tensor:
    """Sobel edge magnitude of (T, H, W, 3) in [0, 1] -> (T, H, W, 1) in
    [0, 1], normalised by the batch's maximum."""
    gray = (rgb01[..., 0] * _GRAY[0] + rgb01[..., 1] * _GRAY[1]
            + rgb01[..., 2] * _GRAY[2]) * 255.0
    gx = _conv3x3_reflect(gray, _SOBEL_X)
    gy = _conv3x3_reflect(gray, _SOBEL_Y)
    mag = torch.sqrt(gx * gx + gy * gy)[..., None]
    return mag / torch.clamp(mag.max(), min=1e-6)


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over a (2r+1)^2 window with zero padding counted, of
    (T, H, W, 1)."""
    k = 2 * r + 1
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, 1, r,
                        count_include_pad=True).permute(0, 2, 3, 1)


def guided_filter(guide_rgb01: torch.Tensor, src: torch.Tensor,
                  radius: int, eps: float) -> torch.Tensor:
    """He et al.'s guided filter with the grey mean of the RGB guide."""
    guide = guide_rgb01.mean(dim=-1, keepdim=True)
    mean_g = _box_filter(guide, radius)
    mean_s = _box_filter(src, radius)
    var_g = _box_filter(guide * guide, radius) - mean_g * mean_g
    cov_gs = _box_filter(guide * src, radius) - mean_g * mean_s
    a = cov_gs / (var_g + eps)
    b = mean_s - a * mean_g
    return _box_filter(a, radius) * guide + _box_filter(b, radius)


def _binary_path(alpha_in: torch.Tensor, rgb01_up: torch.Tensor
                 ) -> torch.Tensor:
    """Mostly-binary alpha: guided refinement, then tight transition zones
    (sigmoid contrast on edges), solid regions and mid-greys snapped."""
    h_out, w_out = rgb01_up.shape[1:3]
    base = torch.clamp(resize_video(alpha_in, h_out, w_out), 0.0, 1.0)
    refined = guided_filter(rgb01_up, base, radius=2, eps=0.002)
    edges = detect_edges(rgb01_up)
    transition = F.max_pool2d(edges.permute(0, 3, 1, 2), 3, 1,
                              1).permute(0, 2, 3, 1)
    alpha_binary = (refined > 0.5).float()
    contrast = torch.sigmoid((refined - 0.5) * 12.0)
    edge_strength = torch.clamp(edges / 0.25, 0.0, 1.0)
    in_edges = refined * (1 - edge_strength) + contrast * edge_strength
    combined = torch.where(transition < 0.05, alpha_binary, in_edges)
    combined = torch.where(transition < 0.03, (combined > 0.5).float(),
                           combined)
    should_bin = (combined > 0.3) & (combined < 0.7) & ~(edges > 0.15)
    out = torch.where(should_bin, (combined > 0.5).float(), combined)
    return torch.clamp(out, 0.0, 1.0)


def _gradient_path(alpha_in: torch.Tensor, rgb01_up: torch.Tensor
                   ) -> torch.Tensor:
    """Soft alpha: the bicubic base through the guided filter alone."""
    h_out, w_out = rgb01_up.shape[1:3]
    base = torch.clamp(resize_video(alpha_in, h_out, w_out), 0.0, 1.0)
    return torch.clamp(guided_filter(rgb01_up, base, radius=3, eps=0.002),
                       0.0, 1.0)


def edge_guided_alpha_upscale(input_alpha: np.ndarray,
                              upscaled_rgb: torch.Tensor) -> torch.Tensor:
    """input_alpha: host (T, H_in, W_in, 1) in [0, 1]; upscaled_rgb:
    (T, H_out, W_out, 3) in [-1, 1] or [0, 1] (taken as [-1, 1] if any value
    is negative). Returns (T, H_out, W_out, 1) on upscaled_rgb's device.
    The path is the binary one when more than 95 % of the alpha values lie
    below 0.1 or above 0.9."""
    rgb01 = upscaled_rgb.float()
    if rgb01.min().item() < 0:
        rgb01 = (rgb01 + 1.0) / 2.0
    flat = input_alpha.reshape(-1)
    binary_ratio = ((flat < 0.1).sum() + (flat > 0.9).sum()) / flat.size
    fn = _binary_path if binary_ratio > 0.95 else _gradient_path
    alpha = spans.to_device(np.ascontiguousarray(input_alpha),
                            rgb01.device, torch.float32)
    return fn(alpha, rgb01)


def process_alpha_for_batch(rgb_upscaled: torch.Tensor,
                            alpha_original: np.ndarray) -> torch.Tensor:
    """Phase-4 entry: upscale a batch's alpha to its decoded RGB.

    Kept as the JAX package (and the reference) has it: under temporal
    overlap the decoded batch dropped its first `overlap` frames when it
    was blended, but alpha_original is the whole padded batch's alpha, so
    alpha frame k pairs with RGB frame k + overlap. A fix must shift both
    sides together. (The JAX function's third argument, the batch's input
    RGB, is unused there and not taken here.)"""
    return edge_guided_alpha_upscale(alpha_original[:rgb_upscaled.shape[0]],
                                     rgb_upscaled)
