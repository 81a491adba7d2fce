"""The VAE decoder's upsample as one GEMM with a pixel-shuffle epilogue.

Upsample3D's 1x1x1 widening conv (Ci -> 4*tr*C channels), its bias, the
MAGViT pixel shuffle (channel ((xi*2 + yi)*tr + z)*C + c lands at output
pixel (t*tr + z, 2h + xi, 2w + yi)), a first slice's drop of the duplicated
frame 1 (JAX's remove_head) and the causal head frames of the 3x3x3 conv
that follows, written as that conv's extended input in one pass:

    out[b, c, n_head + f(t, z), 2h + xi, 2w + yi]
        = round(sum_ci w[r, ci] * x[b, ci, t, h, w] + bias[r])
    r = ((xi*2 + yi)*tr + z)*C + c

the sum and the bias in fp32, one rounding to x's dtype. f(t, z) = t*tr + z,
or with `drop` the frame (0, 1) left out and later frames moved down one.
The n_head head frames are the given `head` (a later slice's carried tail)
or, without one, output frame 0 repeated (a first slice).

The JAX package lowers this step as `lax.conv_transpose` or a matmul plus
`_pixel_shuffle_3d` and has no Pallas kernel for it; on the card the port
takes csrc/upsample_shuffle.cu (its header says what bounds it and how it
is laid out) for every decoder upsample of a CUDA tensor under
`Lowering.use_kernels` (models/vae/model.py `_upsample3d`). On a CPU tensor
`upsample_shuffle` runs the plain version.
"""

import torch

from . import _build
from ..utils import spans

# the kernel's tiles: 64 output channels in both yi phases (128 weight
# rows); a block's unit of x: the positions h*W + w of one input frame that
# plan_units gives, over all Ci channels (at most 128 KB of bf16)
TILE_CHANNELS = 64
# input channels a chunk of the kernel's K loop; the most it takes
K_CHUNK, MAX_CI = 64, 512


def plan_units(b: int, t: int, h: int, w: int, ci: int):
    """(positions a unit, units a frame, units): the kernel's walk over x
    (B, Ci, T, H, W), one unit a block at a time; a unit holds 256
    positions at Ci <= 256, else 128."""
    nt = 256 if ci <= 256 else 128
    ptiles = -(-h * w // nt)
    return nt, ptiles, b * t * ptiles


def upsample_shuffle_plain(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, tr: int, drop: bool = False,
                           n_head: int = 0,
                           head: torch.Tensor = None) -> torch.Tensor:
    """Plain version: x (B, Ci, T, H, W), weight (4*tr*C, Ci), bias
    (4*tr*C,) -> (B, C, n_head + T*tr - drop, 2H, 2W) in x's dtype; the
    matmul and the bias in fp32, rounded once."""
    b, ci, t, h, w = x.shape
    o = weight.shape[0]
    c = o // (4 * tr)
    y = torch.matmul(weight.float(), x.float().reshape(b, ci, t * h * w))
    y = (y + bias.float().view(1, o, 1)).to(x.dtype)
    y = y.view(b, 2, 2, tr, c, t, h, w).permute(0, 4, 5, 3, 6, 1, 7, 2)
    y = y.reshape(b, c, t * tr, 2 * h, 2 * w)
    if drop:
        y = torch.cat([y[:, :, :1], y[:, :, 2:]], dim=2)
    if n_head:
        pre = (y[:, :, :1].expand(-1, -1, n_head, -1, -1) if head is None
               else head.to(y.dtype))
        y = torch.cat([pre, y], dim=2)
    return y


def _check(x, weight, bias, tr, drop, n_head, head):
    if x.dim() != 5 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"upsample_shuffle: x (B, Ci, T, H, W), weight "
                         f"(O, Ci), bias (O,); got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    b, ci, t, h, w = x.shape
    o = weight.shape[0]
    if (tr not in (1, 2) or (drop and tr != 2) or o % (4 * tr)
            or weight.shape[1] != ci or bias.shape[0] != o or n_head < 0):
        raise ValueError(f"upsample_shuffle: weight {tuple(weight.shape)} "
                         f"and bias {tuple(bias.shape)} do not widen x "
                         f"{tuple(x.shape)} by 4 * tr (tr={tr}, drop={drop})")
    want = (b, o // (4 * tr), n_head, 2 * h, 2 * w)
    if head is not None and tuple(head.shape) != want:
        raise ValueError(f"upsample_shuffle: head {tuple(head.shape)}, "
                         f"expected {want}")


def upsample_shuffle(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, tr: int, drop: bool = False,
                     n_head: int = 0,
                     head: torch.Tensor = None) -> torch.Tensor:
    """The decoder's upsample into the next conv's extended input, as the
    module docstring says: x (B, Ci, T, H, W), weight (4*tr*C, Ci) (or the
    conv's (4*tr*C, Ci, 1, 1, 1)), bias (4*tr*C,); head (B, C, n_head, 2H,
    2W) or None (output frame 0 repeated). CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise on what it does not
    take (not bf16, channels not multiples of 64, Ci > 512)."""
    if weight.dim() == 5:
        weight = weight.reshape(weight.shape[:2])
    _check(x, weight, bias, tr, drop, n_head, head)
    if x.device.type == "cpu":
        return upsample_shuffle_plain(x, weight, bias, tr, drop, n_head, head)
    if x.device.type != "cuda":
        raise RuntimeError(f"upsample_shuffle: no kernel for {x.device}")
    b, ci, t, h, w = x.shape
    c = weight.shape[0] // (4 * tr)
    if (x.dtype != torch.bfloat16 or ci % K_CHUNK or ci > MAX_CI
            or c % TILE_CHANNELS or 4 * h * w >= 2 ** 31):
        raise ValueError(f"upsample_shuffle kernel: needs bf16 x with Ci "
                         f"and C multiples of {K_CHUNK}, Ci <= {MAX_CI} "
                         f"and 4*H*W < 2^31; got {x.dtype}, Ci={ci}, C={c}, "
                         f"{h}x{w}")
    weight = weight.to(torch.bfloat16).contiguous()
    bias = bias.to(torch.bfloat16).contiguous()
    hw = h * w
    if hw % 8 or not x.is_contiguous() or x.data_ptr() % 16:
        # TMA's strides are multiples of 16 bytes: frames padded to 8
        # positions (a tile of another size, never the served shapes)
        xp = x.new_empty(b, ci, t, -(-hw // 8) * 8)
        xp[..., :hw].copy_(x.reshape(b, ci, t, hw))
        x, frame_stride = xp, xp.shape[-1]
    else:
        frame_stride = hw
    out = torch.empty((b, c, n_head + t * tr - int(drop), 2 * h, 2 * w),
                      dtype=torch.bfloat16, device=x.device)
    if head is not None and n_head:
        out[:, :, :n_head].copy_(head)
    err = _build.kernel_library().lib.seedvr2_upsample_shuffle(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, ci, t, h, w, frame_stride, c, tr, int(drop), n_head,
        int(head is None), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "seedvr2_upsample_shuffle")
    upsample_shuffle.launches += 1
    spans.count("upsample_kernel_launches", 1)
    return out


upsample_shuffle.launches = 0
