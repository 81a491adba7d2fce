"""--vae_quant int8: the VAE's int8 3x3x3 convolution (kernel K11) and the
quantization around it.

Port of seedvr2_tpu.ops.int8_conv. A causal 3x3x3 conv over an int8
activation with one scale per output frame and int8 weights with one scale
per output channel:

    out[t, h, w, co] = bf16(float(sum_{dt,dh,dw,c} x_ext[t+dt, h+dh, w+dw, c]
                                  * wq[dt*9 + dh*3 + dw, c, co])
                            * (xs[t] * ws[co]))

The sums are int32 and exact. x_ext is the input with the causal head
frames prepended, zero-padded by one pixel on each side, its width padded to
Wp = round_up(W + 2, 32), as the JAX package lays it out.

The public functions keep the JAX layouts: x_ext (T+2, H+2, Wp, C) int8, w
(27, C, Co) int8, x_scales (T,) and w_scales (Co,) fp32, output
(T, H, Wp - 2, Co) bf16. Inside the VAE, which runs NCDHW:
 - `norm_silu_quantize_cthw` reads the (C, T, H, W) activation and writes
   x_ext channels-last: the transpose is folded into the quantizing write;
 - the kernel reads its weight as (Co, 27 * C), K-contiguous
   (`kernel_weight`), and stores its output through the strides its caller
   gives, with the conv's bias added, so the VAE gets (1, Co, T, H, W) bf16
   with no permute pass (`int8_conv3d_ncdhw`).
On a CUDA tensor the conv launches csrc/int8_conv.cu (its header says what
bounds it and how it is laid out) on the tiles `plan_conv` counts; on a CPU
tensor it runs the plain version.
"""

import torch

from . import _build

SUBLANE = 32  # the JAX layout's width padding (the TPU's int8 sublane tile)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as an IEEE division, as jnp's (a CUDA tensor divided by a
    Python scalar is multiplied by its reciprocal instead)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _rdiv(a: float, b: torch.Tensor) -> torch.Tensor:
    """a / b as an IEEE division (`a / tensor` takes the reciprocal)."""
    return torch.full((), a, dtype=b.dtype, device=b.device) / b


def int8_conv_viable(ci: int, co: int, w: int) -> bool:
    """Whether the int8 path serves this conv shape (the JAX rule: channel
    dims that tile the TPU's 128 lanes, at least two columns)."""
    return ci % 128 == 0 and co % 128 == 0 and w >= 2


def quantize_conv_weight(w: torch.Tensor):
    """(kt, kh, kw, Ci, Co) float -> ((27, Ci, Co) int8, (Co,) fp32 scales)
    per output channel, bit-equal to the JAX function: w * (1 / s) in fp32,
    round half to even, an all-zero channel gets scale 0 and zeros."""
    kt, kh, kw, ci, co = w.shape
    w32 = w.float().reshape(kt * kh * kw, ci, co)
    s = _div(torch.amax(torch.abs(w32), dim=(0, 1)), 127.0)
    inv = torch.where(s > 0, _rdiv(1.0, s), torch.zeros_like(s))
    q = torch.clamp(torch.round(w32 * inv[None, None, :]), -127, 127)
    return q.to(torch.int8), s


def kernel_weight(wq: torch.Tensor) -> torch.Tensor:
    """(27, C, Co) int8 -> (Co, 27 * C), the layout K11 reads (k = tap * C
    + c contiguous for each output channel)."""
    taps, c, co = wq.shape
    return wq.permute(2, 0, 1).reshape(co, taps * c).contiguous()


def conv_weight_int8(weight: torch.Tensor):
    """An nn.Conv3d weight (Co, Ci, 3, 3, 3) -> (K11's (Co, 27 * Ci) int8,
    (Co,) fp32 scales), quantized as the JAX package quantizes its
    (3, 3, 3, Ci, Co) weight."""
    wq, ws = quantize_conv_weight(weight.permute(2, 3, 4, 1, 0))
    return kernel_weight(wq), ws


# ---------------------------------------------------------------------------
# norm -> SiLU -> quantize, written in K11's input layout
# ---------------------------------------------------------------------------


def norm_silu_quantize_cthw(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, num_groups: int,
                            head: torch.Tensor = None, eps: float = 1e-6,
                            with_tail: bool = True):
    """GroupNorm (per-frame statistics) -> SiLU -> symmetric int8, as the
    JAX norm_silu_quantize, on x (C, T, H, W) (NCDHW without the batch).

    One statistics pass (mean, E[x^2], max|x| per (frame, group)); the scale
    is the analytic bound max_c(|gamma_c| * zbound_g + |beta_c|) with
    zbound_g = (max|x| + |mean|) * rsqrt(var + eps), at least SiLU's
    negative lobe 0.2785, and at least max|head| when a carried head is
    given; it stays on the device (no host read). Then one pass a frame
    normalizes, applies SiLU, quantizes and writes the frame transposed
    into x_ext.

    head: (C, 2, H, W) the previous slice's carried tail, or None (the
    first slice repeats frame 0). Returns (x_ext (T+2, H+2, Wp, C) int8,
    scale () fp32, tail (C, 2, H, W) in x's dtype, the post-SiLU last two
    frames for the next slice; None without with_tail)."""
    c, t, hh, ww = x.shape
    g = num_groups
    xr = x.reshape(g, c // g, t, hh * ww)
    n = (c // g) * hh * ww
    # fp32 sums read straight from x's dtype: no fp32 copy of the activation
    dims = (1, 3)
    mean = xr.mean(dim=dims, dtype=torch.float32).t()       # (t, g)
    meansq = (torch.linalg.vector_norm(xr, 2, dim=dims, dtype=torch.float32)
              .square() / n).t()
    maxabs = torch.maximum(xr.amax(dim=dims), -xr.amin(dim=dims)).float().t()
    var = torch.clamp_min(meansq - mean.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    g32 = gamma.float().reshape(g, c // g)
    b32 = beta.float().reshape(g, c // g)
    zbound = (maxabs + mean.abs()) * inv                    # (t, g)
    chan_bound = g32.abs()[None] * zbound[..., None] + b32.abs()[None]
    bound = torch.clamp_min(torch.amax(chan_bound), 0.2785)
    if head is not None:
        habs = torch.amax(torch.abs(head.float()))
        scale = _div(torch.maximum(bound, habs), 127.0)
    else:
        scale = _div(bound, 127.0)
    inv_s = _rdiv(1.0, scale)

    def norm_silu(i):
        y = ((xr[:, :, i].float() - mean[i][:, None, None])
             * inv[i][:, None, None]) * g32[..., None] + b32[..., None]
        return torch.nn.functional.silu(y).reshape(c, hh, ww)

    def quant(y32):
        return torch.clamp(torch.round(y32 * inv_s), -127, 127)

    wp = _round_up(ww + 2, SUBLANE)
    x_ext = torch.empty((t + 2, hh + 2, wp, c), dtype=torch.int8,
                        device=x.device)
    x_ext[:, 0] = 0
    x_ext[:, hh + 1] = 0
    x_ext[:, 1:hh + 1, 0] = 0
    x_ext[:, 1:hh + 1, ww + 1:] = 0
    nt = min(2, t)
    tail = []
    for i in range(t):
        y = norm_silu(i)
        # fp32 -> int8 in the transposing copy: the values are integral
        x_ext[i + 2, 1:hh + 1, 1:ww + 1].copy_(quant(y).permute(1, 2, 0))
        if with_tail and i >= t - nt:
            tail.append(y.to(x.dtype))
    if head is not None:
        x_ext[:2, 1:hh + 1, 1:ww + 1].copy_(
            quant(head.float()).permute(1, 2, 3, 0))
    else:
        x_ext[:2] = x_ext[2:3]
    if not with_tail:
        return x_ext, scale, None
    tail = torch.stack(tail, dim=1)                         # (C, nt, H, W)
    if nt < 2:
        pre = (head[:, -(2 - nt):].to(x.dtype) if head is not None
               else tail[:, :1].expand(-1, 2 - nt, -1, -1))
        tail = torch.cat([pre, tail], dim=1)
    return x_ext, scale, tail


def norm_silu_quantize(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, num_groups: int,
                       head: torch.Tensor = None, eps: float = 1e-6):
    """The JAX layout of norm_silu_quantize_cthw: x (1, T, H, W, C), head
    (1, 2, H, W, C) or None -> (x_ext (T+2, H+2, Wp, C) int8, scale () fp32,
    tail (1, 2, H, W, C))."""
    hd = None if head is None else head[0].permute(3, 0, 1, 2)
    x_ext, scale, tail = norm_silu_quantize_cthw(
        x[0].permute(3, 0, 1, 2), gamma, beta, num_groups, head=hd, eps=eps)
    return x_ext, scale, tail.permute(1, 2, 3, 0)[None]


# ---------------------------------------------------------------------------
# K11 and its plain version
# ---------------------------------------------------------------------------


def _tap_product(a: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Exact a (M, C) int8 @ wt (C, Co) int8: int32 through torch._int_mm
    on the card (M > 16), else float64 (exact: |sum| < 27 * C * 127^2 <
    2^53)."""
    if a.is_cuda and a.shape[0] > 16:
        return torch._int_mm(a, wt)
    return torch.matmul(a.double(), wt.double())


def int8_conv3d_plain(x_ext: torch.Tensor, wk: torch.Tensor,
                      xs: torch.Tensor, ws: torch.Tensor,
                      bias: torch.Tensor = None,
                      w_out: int = None) -> torch.Tensor:
    """Plain version of K11 on the kernel's layouts: x_ext (T+2, H+2, Wp, C)
    int8, wk (Co, 27 * C) int8 -> (Co, T, H, w_out) bf16 (w_out defaults to
    Wp - 2). The sums are 27 shifted exact products; converted to fp32 as
    an int32 is (round to nearest even), times xs[t] * ws[co] (the JAX
    kernel's order), rounded once to bf16; the bias, if given, is then
    added in bf16 as the VAE adds it."""
    tp, hp, wp, c = x_ext.shape
    t, h = tp - 2, hp - 2
    w_out = wp - 2 if w_out is None else w_out
    co = wk.shape[0]
    taps = wk.view(co, 27, c)
    acc = None
    for tap in range(27):
        dt, dh, dw = tap // 9, tap // 3 % 3, tap % 3
        a = x_ext[dt:dt + t, dh:dh + h, dw:dw + w_out].reshape(-1, c)
        prod = _tap_product(a, taps[:, tap].contiguous().t())
        acc = prod if acc is None else acc.add_(prod)
    sums = acc.float().reshape(t, h, w_out, co).permute(3, 0, 1, 2)
    out = (sums * (xs.float().view(1, t, 1, 1)
                   * ws.float().view(co, 1, 1, 1))).to(torch.bfloat16)
    if bias is not None:
        out = out + bias.to(torch.bfloat16).view(co, 1, 1, 1)
    # the kernel's layout: what follows the conv then runs the same way
    return out.contiguous()


# K11's tiles: PIX_TILE consecutive output positions p = h * Wp + w of one
# frame (the rows of h they span included) by CO_TILE output channels
PIX_TILE, CO_TILE = 256, 128


def plan_conv(t: int, h: int, wp: int, w_out: int, co: int):
    """K11's tiles for a (T, H, Wp) x_ext, W_out columns and Co channels:
    (pixel tiles a frame, channel tiles, busy share). A frame's H * Wp
    positions over the padded width are cut into tiles of PIX_TILE, so a
    tile spans rows of h and a narrow frame idles only its pad columns;
    the busy share is the stored outputs over the positions computed."""
    pix_tiles = -(-h * wp // PIX_TILE)
    co_tiles = -(-co // CO_TILE)
    busy = (h * w_out * co) / (pix_tiles * PIX_TILE * co_tiles * CO_TILE)
    return pix_tiles, co_tiles, busy


def _launch(x_ext, wk, xs, ws, bias, out, w_out: int) -> None:
    """K11 into `out`, a (Co, T, H, >= w_out) bf16 view of any strides."""
    tp, hp, wp, c = x_ext.shape
    co = wk.shape[0]
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
    for name, v, dt in (("x_ext", x_ext, torch.int8), ("wk", wk, torch.int8),
                        ("xs", xs, torch.float32), ("ws", ws, torch.float32),
                        ("bias", bias, torch.bfloat16)):
        if v is None:
            continue
        if v.dtype != dt or not v.is_contiguous() or v.device != x_ext.device:
            raise ValueError(f"int8_conv3d kernel: {name} must be contiguous "
                             f"{dt} on {x_ext.device}, got {v.dtype} on "
                             f"{v.device}")
    if out.dtype != torch.bfloat16 or out.device != x_ext.device:
        raise ValueError("int8_conv3d kernel: out must be bf16 on "
                         f"{x_ext.device}")
    if (c % 16 or co % 8 or x_ext.data_ptr() % 16 or wk.data_ptr() % 16
            or tp - 2 > 65535 or hp - 2 > 65535):
        raise ValueError(f"int8_conv3d kernel: needs C % 16 == 0 (C={c}), "
                         f"Co % 8 == 0 (Co={co}), T and H <= 65535 and "
                         "16-byte aligned operands")
    sc, st, sh, sw = out.stride()
    pix_tiles, co_tiles, _ = plan_conv(tp - 2, hp - 2, wp, w_out, co)
    err = _build.kernel_library().lib.seedvr2_int8_conv3d(
        x_ext.data_ptr(), wk.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        tp - 2, hp - 2, wp, c, co, w_out, sc, st, sh, sw, pix_tiles,
        co_tiles, torch.cuda.current_stream(x_ext.device).cuda_stream)
    _build.check(err, "seedvr2_int8_conv3d")
    int8_conv3d.launches += 1


def _check_shapes(x_ext, wk, xs, ws):
    tp, hp, wp, c = x_ext.shape
    co = wk.shape[0]
    if (wk.shape != (co, 27 * c) or xs.shape != (tp - 2,)
            or ws.shape != (co,) or wp % SUBLANE):
        raise ValueError(f"int8_conv3d: shapes x_ext {tuple(x_ext.shape)} "
                         f"w {tuple(wk.shape)} xs {tuple(xs.shape)} ws "
                         f"{tuple(ws.shape)} do not match (Wp % {SUBLANE} "
                         "== 0)")


def int8_conv3d_ncdhw(x_ext: torch.Tensor, wk: torch.Tensor,
                      xs: torch.Tensor, ws: torch.Tensor,
                      bias: torch.Tensor, w_out: int) -> torch.Tensor:
    """The VAE's call: K11 on the kernel's layouts with the conv's bias,
    returning (1, Co, T, H, w_out) bf16. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise on what it does not
    take."""
    _check_shapes(x_ext, wk, xs, ws)
    tp, hp, wp, c = x_ext.shape
    if x_ext.device.type == "cpu":
        return int8_conv3d_plain(x_ext, wk, xs, ws, bias, w_out)[None]
    if x_ext.device.type != "cuda":
        raise RuntimeError(f"int8_conv3d: no kernel for {x_ext.device}")
    out = torch.empty((1, wk.shape[0], tp - 2, hp - 2, w_out),
                      dtype=torch.bfloat16, device=x_ext.device)
    _launch(x_ext, wk, xs, ws, bias, out[0], w_out)
    return out


def int8_conv3d(x_ext: torch.Tensor, w: torch.Tensor, x_scales: torch.Tensor,
                w_scales: torch.Tensor) -> torch.Tensor:
    """The JAX package's int8_conv3d: x_ext (T+2, H+2, Wp, C) int8, w
    (27, C, Co) int8, x_scales (T,), w_scales (Co,) fp32 -> (T, H, Wp - 2,
    Co) bf16. CPU tensors take the plain version; CUDA tensors launch K11,
    or raise on what it does not take."""
    wk = kernel_weight(w)
    _check_shapes(x_ext, wk, x_scales, w_scales)
    if x_ext.device.type == "cpu":
        return int8_conv3d_plain(x_ext, wk, x_scales,
                                 w_scales).permute(1, 2, 3, 0)
    if x_ext.device.type != "cuda":
        raise RuntimeError(f"int8_conv3d: no kernel for {x_ext.device}")
    tp, hp, wp, _ = x_ext.shape
    out = torch.empty((tp - 2, hp - 2, wp - 2, w.shape[-1]),
                      dtype=torch.bfloat16, device=x_ext.device)
    _launch(x_ext, wk, x_scales, w_scales, None, out.permute(3, 0, 1, 2),
            wp - 2)
    return out


int8_conv3d.launches = 0


def int8_causal_conv3d(x: torch.Tensor, w: torch.Tensor, bias,
                       head: torch.Tensor = None) -> torch.Tensor:
    """The JAX package's drop-in int8 path for a full causal (3, 3, 3) conv
    on one batch element: x (1, T, H, W, Ci) (not yet extended), w
    (3, 3, 3, Ci, Co); head (1, 2, H, W, Ci) the carried tail or None
    (repeat frame 0). One per-tensor scale over the extended input."""
    if x.shape[0] != 1:
        raise ValueError("int8_causal_conv3d takes one batch element")
    t, _, ww = x.shape[1], x.shape[2], x.shape[3]
    x32 = x[0].float()
    if head is not None:
        x32 = torch.cat([head[0].float(), x32], dim=0)
    absmax = torch.amax(torch.abs(x32))
    zero = torch.zeros_like(absmax)
    inv = torch.where(absmax > 0, _rdiv(127.0, absmax), zero)
    xq = torch.clamp(torch.round(x32 * inv), -127, 127).to(torch.int8)
    if head is None:
        xq = torch.cat([xq[:1].expand(2, -1, -1, -1), xq], dim=0)
    wp = _round_up(ww + 2, SUBLANE)
    x_ext = torch.nn.functional.pad(xq, (0, 0, 1, wp - ww - 1, 1, 1))
    gscale = torch.where(absmax > 0, _div(absmax, 127.0), zero)
    wq, ws = quantize_conv_weight(w)
    out = int8_conv3d(x_ext, wq, gscale.expand(t).contiguous(), ws)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out[None, :, :, :ww]
