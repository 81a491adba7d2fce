"""Quantised-checkpoint lanes: Q8_0 and 4-bit affine weights served through
dequantizing GEMMs (kernels K6 and K7), the quantizers, the quantised
linears and the DiT conversions.

Port of seedvr2_tpu.ops.quant_matmul. Weights keep one int8 per value and
fp32 tables per 32-group along K:

 - Q8_0 (`--quant q8`, GGUF Q8_0): w = q * s, q in [-127, 127];
 - affine (`--quant q4`, native GGUF Q4_K/Q5_K under `--quant q4k`):
   w = q * s - m, q in [0, 15] (PTQ) or [0, 31] (Q5_K).

Layout: the port stores a weight (N, K) = (out, in), K-contiguous, with its
tables (N, K/32): the GGUF's own order, in which the weights are the
kernels' register A operand and x their K-major B operand (the JAX package
stores (K, N) and (K/32, N)).

On a CUDA tensor `quant_matmul_q8` and `quant_matmul_affine` launch the
hand-written kernels of `csrc/quant_matmul.cu` (its header says what bounds
them and how they keep the fp32 arithmetic exact), with the token width and
K split `plan_tiles` picks; on a CPU tensor they run the plain versions,
the JAX package's non-TPU emulation. Both write bf16, or with
`out_dtype=torch.float32` the unrounded fp32 product (the kernels' fp32
epilogue, and an fp32 split-K reduction): what a row-sharded projection
under tensor parallelism sums over the tp ranks before its one rounding
(`quant_linear(..., reduce)`).
"""

import functools
from typing import Optional

import torch
from torch import nn

from . import _build

GROUP = 32


def _groups(w: torch.Tensor) -> torch.Tensor:
    n, k = w.shape
    if k % GROUP:
        raise ValueError(f"K={k} is not a multiple of {GROUP}")
    return w.float().reshape(n, k // GROUP, GROUP)


def quantize_q8(w: torch.Tensor):
    """(N, K) float weight -> (q int8 (N, K), scales fp32 (N, K/32)); GGUF
    Q8_0: scale = absmax / 127 per 32-group, q = round_half_even(w * 1/s).
    The JAX quantize_q8's arithmetic on its (K, N) transpose, bit for bit."""
    w32 = _groups(w)
    scales = torch.amax(torch.abs(w32), dim=2) / 127.0
    inv = torch.where(scales > 0, 1.0 / scales, torch.zeros_like(scales))
    q = torch.clamp(torch.round(w32 * inv[..., None]), -127, 127)
    return q.to(torch.int8).reshape(w.shape), scales


def dequantize_q8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 and (N, K/32) scales -> (N, K) fp32."""
    return (_groups(q) * scales[..., None]).reshape(q.shape)


def quantize_affine4(w: torch.Tensor):
    """(N, K) float weight -> 4-bit affine (q int8 (N, K) in [0, 15],
    s fp32 (N, K/32), m fp32 (N, K/32)) with w ~= q * s - m per 32-group:
    the layout native Q4_K lands in, so PTQ q4 serves through the same K7.
    The JAX quantize_affine4's arithmetic, bit for bit."""
    w32 = _groups(w)
    mn = torch.amin(w32, dim=2)
    mx = torch.amax(w32, dim=2)
    s = (mx - mn) / 15.0
    inv = torch.where(s > 0, 1.0 / s, torch.zeros_like(s))
    q = torch.clamp(torch.round((w32 - mn[..., None]) * inv[..., None]), 0, 15)
    return q.to(torch.int8).reshape(w.shape), s, -mn


def dequantize_affine(q: torch.Tensor, s: torch.Tensor,
                      m: torch.Tensor) -> torch.Tensor:
    """(N, K) quants and (N, K/32) tables -> (N, K) fp32 q * s - m."""
    return (_groups(q) * s[..., None] - m[..., None]).reshape(q.shape)


# ------------------------------------------------------------------ kernels


def quant_matmul_q8_plain(x: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, out_dtype=None
                          ) -> torch.Tensor:
    """Plain version of K6: x (M, K) @ dequantized (N, K)^T in fp32, rounded
    to out_dtype (default x's dtype)."""
    return torch.matmul(x.float(), dequantize_q8(q, scales).t()).to(
        out_dtype or x.dtype)


def quant_matmul_affine_plain(x: torch.Tensor, q: torch.Tensor,
                              s: torch.Tensor, m: torch.Tensor,
                              out_dtype=None) -> torch.Tensor:
    """Plain version of K7: x (M, K) @ (q * s - m)^T in fp32, rounded to
    out_dtype (default x's dtype)."""
    return torch.matmul(x.float(), dequantize_affine(q, s, m).t()).to(
        out_dtype or x.dtype)


def group_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's pre-pass on x: xg (M, K/32) fp32, the sum of
    each row's 32 values of every group, as the JAX kernel forms it."""
    m, k = x.shape
    return x.float().reshape(m, k // GROUP, GROUP).sum(dim=2)


def min_planes_plain(m: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's pre-pass on the min table m (N, K/32) fp32:
    -m split into bf16 planes (2, N, K/32), hi = bf16(-m) and lo = bf16(-m
    - hi), so that hi + lo is within 2^-16 of -m relative (the kernel's
    min term takes hi*hi + hi*lo + lo*hi of these and of xg's planes)."""
    hi = (-m).to(torch.bfloat16)
    return torch.stack([hi, (-m - hi.float()).to(torch.bfloat16)])


# the card's SMs: a split K keeps at least this many blocks streaming the
# weights where the token tiles alone would leave SMs idle
SMS = 132
# groups a stage of the kernels' ring holds; a split starts on a stage
STAGE_GROUPS = 4
# least groups a split takes (two stages)
MIN_SPLIT_GROUPS = 8


@functools.lru_cache(maxsize=None)
def plan_tiles(m: int, n: int, k: int):
    """(token width, K splits) of K6/K7 for an (M, N, K) product: tokens are
    the wgmma N (8 for M <= 8, 64 for M <= 64, else 128); where the grid
    of 128-row weight tiles by token tiles has fewer than SMS blocks, K is
    split in the fewest parts that fill the card, each a divisor of K/32
    into whole stages of at least MIN_SPLIT_GROUPS groups."""
    groups = k // GROUP
    bt = 8 if m <= 8 else 64 if m <= 64 else 128
    blocks = -(-n // 128) * -(-m // bt)
    splits = 1
    for d in range(2, groups // MIN_SPLIT_GROUPS + 1):
        if blocks * splits >= SMS:
            break
        if groups % d == 0 and (groups // d) % STAGE_GROUPS == 0:
            splits = d
    return bt, splits


def _check(name: str, x: torch.Tensor, q: torch.Tensor, tables) -> None:
    m, k = x.shape
    n, k2 = q.shape
    if k != k2 or k % GROUP or any(t.shape != (n, k // GROUP)
                                   for t in tables):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} q "
                         f"{tuple(q.shape)} tables "
                         f"{[tuple(t.shape) for t in tables]} do not match "
                         f"(K % {GROUP} == 0)")


def _check_kernel(name: str, x, q, tables) -> None:
    """Raise on what the kernels do not take."""
    n = q.shape[0]
    for label, t, dt in (("x", x, torch.bfloat16), ("q", q, torch.int8),
                         *((f"table {i}", t, torch.float32)
                           for i, t in enumerate(tables))):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} kernel: {label} must be contiguous {dt} "
                             f"on {x.device}, got {t.dtype} on {t.device}")
    if n % 2 or any(t.data_ptr() % 16 for t in (x, q, *tables)):
        raise ValueError(f"{name} kernel: needs N % 2 == 0 (N={n}) and "
                         "16-byte aligned operands")


def _tables_g4(tables):
    """The tables with their K/32 columns zero-padded to a multiple of 4
    (16-byte rows, as the kernels' TMA loads need); as they are when
    already so."""
    g = tables[0].shape[1]
    pad = -g % 4
    if not pad:
        return tables, g
    return [torch.nn.functional.pad(t, (0, pad)) for t in tables], g + pad


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _xg_width(k: int) -> int:
    """Columns of K7's pre-pass planes (xg and -m): K/32 rounded up to 8
    (16-byte rows for the kernel's TMA loads)."""
    return -(-k // (8 * GROUP)) * 8


def k7_prepass(x: torch.Tensor, m: torch.Tensor):
    """K7's pre-pass kernel alone, one launch as K7 makes it: the bf16 hi
    and lo planes (2, M, XW) of the group sums of x (M, K) bf16 and (2, N,
    XW) of -m, m (N, K/32) fp32; XW = K/32 rounded up to 8, zeros past
    K/32. CPU tensors take the plain versions."""
    rows, k = x.shape
    n, g = m.shape
    if k % GROUP or g != k // GROUP:
        raise ValueError(f"k7_prepass: x {tuple(x.shape)} and m "
                         f"{tuple(m.shape)} do not match (K % {GROUP} == 0)")
    xw = _xg_width(k)
    if x.device.type == "cpu":
        sums = group_sums_plain(x)
        hi = sums.to(torch.bfloat16)
        planes = (torch.stack([hi, (sums - hi.float()).to(torch.bfloat16)]),
                  min_planes_plain(m))
        return tuple(torch.nn.functional.pad(p, (0, xw - g)) for p in planes)
    if (x.dtype != torch.bfloat16 or not x.is_contiguous()
            or x.data_ptr() % 16 or m.dtype != torch.float32
            or not m.is_contiguous() or m.device != x.device):
        raise ValueError("k7_prepass kernel: needs x contiguous 16-byte "
                         "aligned bf16 and m contiguous fp32 on one device, "
                         f"got {x.dtype}, {m.dtype}")
    xg = torch.empty((2, rows, xw), dtype=torch.bfloat16, device=x.device)
    mnp = torch.empty((2, n, xw), dtype=torch.bfloat16, device=x.device)
    if (rows or n) and k:
        _build.check(_build.kernel_library().lib.seedvr2_k7_prepass(
            x.data_ptr(), xg.data_ptr(), m.data_ptr(), mnp.data_ptr(), rows,
            n, k, g, xw, _stream(x)), "seedvr2_k7_prepass")
    return xg, mnp


def group_sums(x: torch.Tensor) -> torch.Tensor:
    """The group sums xg (M, K/32) fp32 of x (M, K) bf16 through K7's
    pre-pass kernel, read back from its bf16 hi + lo planes (within 2^-17
    of the fp32 sums). CPU tensors take the plain version."""
    m, k = x.shape
    if k % GROUP:
        raise ValueError(f"group_sums: K={k} is not a multiple of {GROUP}")
    if x.device.type == "cpu":
        return group_sums_plain(x)
    xg, _ = k7_prepass(x, torch.empty((0, k // GROUP), device=x.device))
    return (xg[0].float() + xg[1].float())[:, :k // GROUP]


def split_reduce_plain(ws: torch.Tensor, out_dtype=torch.bfloat16
                       ) -> torch.Tensor:
    """Plain version of the split-K reduction: ws (splits, M, N) fp32 summed
    over the splits in order, rounded to out_dtype (bf16 or fp32)."""
    acc = ws[0].clone()
    for part in ws[1:]:
        acc += part
    return acc.to(out_dtype)


def _out_dtype(name: str, out_dtype):
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} kernel writes bf16 or fp32, not "
                         f"{out_dtype}")
    return out_dtype == torch.float32


def split_reduce(ws: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The split-K reduction kernel alone (CPU tensors take the plain
    version); bit-equal to split_reduce_plain."""
    if ws.device.type == "cpu":
        return split_reduce_plain(ws, out_dtype)
    f32 = _out_dtype("split_reduce", out_dtype)
    splits, m, n = ws.shape
    if (ws.dtype != torch.float32 or not ws.is_contiguous() or n % 2
            or ws.data_ptr() % 16):
        raise ValueError("split_reduce kernel: ws must be contiguous fp32 "
                         "(splits, M, N), N even")
    out = torch.empty((m, n), dtype=out_dtype, device=ws.device)
    if m and n:
        _build.check(_build.kernel_library().lib.seedvr2_split_reduce(
            ws.data_ptr(), out.data_ptr(), m * n // 2, splits, int(f32),
            _stream(ws)), "seedvr2_split_reduce")
    return out


def _launch(name: str, x, q, tables, out_dtype) -> torch.Tensor:
    """Check what the kernel takes, plan its tiles, allocate the output and
    scratch, launch on the current stream and raise on a launch error."""
    f32 = _out_dtype(name, out_dtype)
    _check_kernel(name, x, q, tables)
    m, k = x.shape
    n = q.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if not (m and n):
        return out
    tables, g4 = _tables_g4(tables)
    bt, splits = plan_tiles(m, n, k)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    ws_ptr = None if ws is None else ws.data_ptr()
    lib = _build.kernel_library().lib
    if len(tables) == 1:
        fn = "seedvr2_quant_matmul_q8"
        err = lib.seedvr2_quant_matmul_q8(
            x.data_ptr(), q.data_ptr(), tables[0].data_ptr(), ws_ptr,
            out.data_ptr(), m, n, k, g4, bt, splits, int(f32), _stream(x))
    else:
        fn = "seedvr2_quant_matmul_affine"
        xw = _xg_width(k)
        xg = torch.empty((2, m, xw), dtype=torch.bfloat16, device=x.device)
        mnp = torch.empty((2, n, xw), dtype=torch.bfloat16, device=x.device)
        err = lib.seedvr2_quant_matmul_affine(
            x.data_ptr(), q.data_ptr(), tables[0].data_ptr(),
            tables[1].data_ptr(), xg.data_ptr(), mnp.data_ptr(), ws_ptr,
            out.data_ptr(), m, n, k, g4, xw, bt, splits, int(f32),
            _stream(x))
    _build.check(err, fn)
    return out


def quant_matmul_q8(x: torch.Tensor, q: torch.Tensor,
                    scales: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ (q (N, K) int8 * scales (N, K/32) per 32-group)^T ->
    (M, N) in out_dtype (default x's dtype), fp32 accumulation.

    CPU tensors take the plain version. CUDA tensors launch K6 (its fp32
    epilogue for an fp32 out_dtype), or raise on what it does not take:
    bf16 x, bf16 or fp32 output, contiguous 16-byte aligned operands on one
    device, K % 32 == 0, N even."""
    _check("quant_matmul_q8", x, q, (scales,))
    if x.device.type == "cpu":
        return quant_matmul_q8_plain(x, q, scales, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul_q8: no kernel for {x.device}")
    out = _launch("quant_matmul_q8", x, q, (scales,), out_dtype or x.dtype)
    quant_matmul_q8.launches += 1
    quant_matmul_q8.launches_f32 += out.dtype == torch.float32
    return out


# launches of the kernel, and of them those with the fp32 epilogue
quant_matmul_q8.launches = 0
quant_matmul_q8.launches_f32 = 0


def quant_matmul_affine(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                        m: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ (q * s - m per 32-group)^T -> (M, N) in out_dtype
    (default x's dtype); q (N, K) int8 raw quants, s and m (N, K/32) fp32.
    The min term is taken as group_sums(x) @ m, as in the JAX kernel.

    CPU tensors take the plain version; CUDA tensors launch K7 (its
    pre-pass first: the group sums and -m as bf16 planes) or raise (as
    quant_matmul_q8)."""
    _check("quant_matmul_affine", x, q, (s, m))
    if x.device.type == "cpu":
        return quant_matmul_affine_plain(x, q, s, m, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"quant_matmul_affine: no kernel for {x.device}")
    out = _launch("quant_matmul_affine", x, q, (s, m), out_dtype or x.dtype)
    quant_matmul_affine.launches += 1
    quant_matmul_affine.launches_f32 += out.dtype == torch.float32
    return out


quant_matmul_affine.launches = 0
quant_matmul_affine.launches_f32 = 0


# ------------------------------------------------------------------ linears


class Q8Linear(nn.Module):
    """A Q8_0 linear: int8 weight `q8` (N, K), fp32 `scales` (N, K/32), and
    the float bias of the linear it replaced (or none). Buffers, not
    parameters: nothing here is trained. State-dict keys are the JAX tree's
    leaf names (<layer>.q8, .scales, .bias)."""

    def __init__(self, q8: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def in_features(self) -> int:
        return self.q8.shape[1]

    @property
    def out_features(self) -> int:
        return self.q8.shape[0]

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Q8Linear":
        q, s = quantize_q8(lin.weight.detach())
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(q, s, bias)

    @classmethod
    def empty_like(cls, lin: nn.Linear) -> "Q8Linear":
        """Uninitialised buffers of `lin`'s shapes, on its device, to be
        filled by load_state_dict."""
        n, k = lin.weight.shape
        dev = lin.weight.device
        bias = None if lin.bias is None else torch.empty_like(lin.bias)
        return cls(torch.empty((n, k), dtype=torch.int8, device=dev),
                   torch.empty((n, k // GROUP), device=dev), bias)


class AffineLinear(nn.Module):
    """A 4-bit affine linear (PTQ q4, native Q4_K/Q5_K): raw quants `qa`
    (N, K) int8, fp32 `s` and `m` (N, K/32), w = qa * s - m per group, and
    the float bias (or none). Keys <layer>.qa, .s, .m, .bias."""

    def __init__(self, qa: torch.Tensor, s: torch.Tensor, m: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("qa", qa)
        self.register_buffer("s", s)
        self.register_buffer("m", m)
        self.register_buffer("bias", bias)

    @property
    def in_features(self) -> int:
        return self.qa.shape[1]

    @property
    def out_features(self) -> int:
        return self.qa.shape[0]

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "AffineLinear":
        qa, s, m = quantize_affine4(lin.weight.detach())
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(qa, s, m, bias)

    @classmethod
    def empty_like(cls, lin: nn.Linear) -> "AffineLinear":
        n, k = lin.weight.shape
        dev = lin.weight.device
        bias = None if lin.bias is None else torch.empty_like(lin.bias)
        return cls(torch.empty((n, k), dtype=torch.int8, device=dev),
                   torch.empty((n, k // GROUP), device=dev),
                   torch.empty((n, k // GROUP), device=dev), bias)


def _finish(out: torch.Tensor, lead, bias, dtype, reduce) -> torch.Tensor:
    """(M, N) product -> (*lead, N): with `reduce` the fp32 product summed
    over the tp ranks first; rounded to dtype, then the bias."""
    if reduce is not None:
        out = reduce(out)
    out = out.to(dtype).reshape(*lead, -1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def quant_linear(x: torch.Tensor, layer: Q8Linear,
                 use_kernels: bool = True, reduce=None) -> torch.Tensor:
    """linear() for a Q8Linear: the product rounded to x's dtype, then the
    bias. x: (..., K). reduce: row-sharded tensor parallelism, as the JAX
    package's psum_axis: K6 writes the local K slice's product in fp32,
    `reduce` sums it over the tp ranks, one rounding, the bias once."""
    mm = quant_matmul_q8 if use_kernels else quant_matmul_q8_plain
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    f32 = None if reduce is None else torch.float32
    return _finish(mm(x2, layer.q8, layer.scales, f32), x.shape[:-1],
                   layer.bias, x.dtype, reduce)


def affine_quant_linear(x: torch.Tensor, layer: AffineLinear,
                        use_kernels: bool = True, reduce=None
                        ) -> torch.Tensor:
    """linear() for an AffineLinear (as quant_linear, K7)."""
    mm = quant_matmul_affine if use_kernels else quant_matmul_affine_plain
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    f32 = None if reduce is None else torch.float32
    return _finish(mm(x2, layer.qa, layer.s, layer.m, f32), x.shape[:-1],
                   layer.bias, x.dtype, reduce)


# --------------------------------------------------------------- conversion


def _convert(model: nn.Module, cls, min_dim: int) -> nn.Module:
    targets = [name for name, mod in model.named_modules()
               if isinstance(mod, nn.Linear)
               and min(mod.in_features, mod.out_features) >= min_dim
               and mod.in_features % GROUP == 0]
    for name in targets:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, attr, cls.from_linear(getattr(parent, attr)))
    return model


def quantize_dit_q8(model: nn.Module, min_dim: int = 1024) -> nn.Module:
    """Post-training Q8_0 conversion in place, the counterpart of the JAX
    package's quantize_dit_params: every nn.Linear with min(K, N) >= min_dim
    and K % 32 == 0 becomes a Q8Linear (no N alignment); smaller and IO
    projections stay dense. Layers convert one at a time on their own
    device, so peak memory stays near the float model's. Returns the model."""
    return _convert(model, Q8Linear, min_dim)


def quantize_dit_affine4(model: nn.Module, min_dim: int = 1024) -> nn.Module:
    """Post-training 4-bit affine conversion in place (the JAX
    quantize_dit_params_affine4), with quantize_dit_q8's rule."""
    return _convert(model, AffineLinear, min_dim)
