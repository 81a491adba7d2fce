#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seedvr2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU, `nvcc` and no
network. In order it:

 1. prints the card (nvidia-smi name and power limit), the torch and CUDA
    versions, and builds the hand-written kernels from csrc/ (nvcc time);
 2. holds each kernel against its plain PyTorch version at 3B shapes on the
    card: K1 (packed window attention) within bf16 tolerance, K2 (row
    gather) and K3 (int8 GEMM) exactly, K4 (rms_norm + ada + quantize) and
    K5 (silu*up + quantize) within one int8 step, at the shapes of the 720p
    clip and of the throughput requests of phase 5 (their token counts are
    the GEMM and quantize rows); times each with CUDA events after an L2
    flush, beside its plain version, the one PyTorch call that computes the
    same function where there is one, and its bound;
 3. the default path: builds the 3B DiT (32 layers, width 2560) and VAE_V3
    with random weights drawn on the card from a seed, and serves three
    requests through the port's `process_frames` (a 360x640 image to 720p,
    a 5-frame 360x640 clip to 720p, the clip again), checking shapes and
    finiteness and that K1 and K2 were launched by that path;
 4. runs the whole 32-layer DiT once with the kernels and once with their
    plain versions on the clip's latent and bounds the relative L2 error;
 5. the throughput path (`--preset throughput`): the same weights converted
    to w8a8; on the 1080p clip's latent the whole w8a8 DiT with kernels
    against plain versions (bound) and against the bf16 DiT (it must lie
    closer to the former); then four requests through `process_frames` with
    the preset's VAE tiling (a 5-frame 540x960 clip to 1080p, a 1080x1920
    image to 4K, each twice), checking shapes, range and that K1-K5 were
    all launched by that path;
 6. prints the kernels' JSON record, the card line again, and last
    {"ok": true, "device": {...}}.

Any failure ends the run with a non-zero exit and no last line. It imports
nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

# Tolerances, stated with their reasons:
# K1 vs plain, per element: both round q/k and the probabilities to bf16 but
# at different points (the kernel folds scale*log2e into q before the bf16
# cast, the plain version scales fp32 logits), and the output is bf16; the
# JAX package holds its Pallas kernel to its jnp composition at the same
# bound (tests/test_flash_attention.py).
K1_ATOL = K1_RTOL = 2e-2
# K4/K5 vs plain: the row sums and rsqrt run in another order, which can move
# y / scale across a .5 rounding boundary: q within 1 everywhere, equal in
# at least 99.9 % of entries; scales within rtol 1e-6.
Q_MAX_DIFF, Q_EQUAL_SHARE, S_RTOL = 1, 0.999, 1e-6
# whole 32-layer bf16 DiT, kernels vs plain versions: per-layer bf16-class
# differences of the attention output propagate through 32 residual blocks
# of a random-weight model; bounded as a bf16-class relative L2 error.
DIT_REL_L2 = 2e-2
# whole w8a8 DiT, kernels vs plain versions: the same bf16-class attention
# differences, which the per-row int8 quantizations downstream turn into
# +-1 steps wherever they move y / scale across a .5 boundary. Its own,
# tighter limit: it must sit below the w8a8-vs-bf16 gap on the same weights
# (about 9e-3 on the H100), so that a path that skipped the quantization
# fails; the smoke also requires the kernels' output to lie closer to the
# w8a8 plain output than to the bf16 DiT's.
W8A8_DIT_REL_L2 = 8e-3
# the packaged positive text embedding's length (checked in phase 3)
TXT_LEN = 58
# the throughput path's requests: (label, frames, height, width, short side)
FAST_REQUESTS = (("clip 5x540x960 -> 1080", 5, 540, 960, 1080),
                 ("image 1x1080x1920 -> 2160", 1, 1080, 1920, 2160))

# H100 SXM data-sheet peaks (dense), for the bounds
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12      # CUDA cores, outside the tensor cores
PEAK_BYTES = 3.35e12
# fp32 operations a K4 / K5 element costs (square-add, norm, scale, shift,
# abs-max, divide, round, clamp; K5: exp, add, divide, multiply, then the
# same quantization)
K4_OPS_PER_ELEM, K5_OPS_PER_ELEM = 10, 12

KERNELS = {
    "K1": ("packed_window_attention", "seedvr2_tpu_torch/csrc/packed_attention.cu",
           "comfyui-seedvr2_tpu/ops/flash_attention.py:224"),
    "K2": ("gather_rows", "seedvr2_tpu_torch/csrc/gather_rows.cu",
           "comfyui-seedvr2_tpu/ops/gather.py:70"),
    "K3": ("int8_matmul", "seedvr2_tpu_torch/csrc/int8_matmul.cu",
           "comfyui-seedvr2_tpu/ops/int8_matmul.py:32"),
    "K4": ("rms_ada_quantize", "seedvr2_tpu_torch/csrc/fused_quant.cu",
           "comfyui-seedvr2_tpu/ops/fused_quant.py:63"),
    "K5": ("silu_mul_quantize", "seedvr2_tpu_torch/csrc/fused_quant.cu",
           "comfyui-seedvr2_tpu/ops/fused_quant.py:123"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() over `iters` back-to-back calls,
    CUDA events (warm caches)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = []


def kernel_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of one call of fn(), each call timed alone with
    CUDA events after a 256 MB write that evicts the 50 MB L2, so inputs
    come from device memory as they would in the model."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_ms(ops: float, peak_ops: float, nbytes: float):
    """(least time in ms, what bounds it): the larger of ops over the peak
    rate for their type and bytes over the memory rate."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def rope_tables(torch, gen, s: int, d: int, device):
    ang = torch.randn(s, d // 2, generator=gen, device=device)
    return (torch.cos(ang).repeat_interleave(2, -1).contiguous(),
            torch.sin(ang).repeat_interleave(2, -1).contiguous())


def sdpa_inputs(torch, qkv, heads, d, tabs, eps, kv_len):
    """The attention core's inputs as K1's plain version forms them
    (normed, roped q and k in bf16; v) in (B, H, S, D), and the key mask."""
    from seedvr2_tpu_torch.models.dit.rope import rotate_half_full

    b, s, _ = qkv.shape
    x = qkv.reshape(b, s, 3, heads, d)
    cq, sq, ck, sk = tabs

    def norm_rope(z, cos, sin):
        z = z.float()
        z = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + eps)
        z = z * cos[:, None, :] + rotate_half_full(z) * sin[:, None, :]
        return z.to(qkv.dtype).transpose(1, 2).contiguous()

    q = norm_rope(x[:, :, 0], cq, sq)
    k = norm_rope(x[:, :, 1], ck, sk)
    v = x[:, :, 2].transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=qkv.device) < kv_len)[None, None, None, :]
    return q, k, v, mask


def latent_shape(vae_cfg, t: int, h: int, w: int, res: int):
    """Latent (T, H, W) of a request of t frames h x w served at short side
    `res`: resized and padded to a multiple of 16 as
    utils.transforms.prepare_video does, then the VAE's temporal and spatial
    downsampling of the 4n+1 frame block."""
    from seedvr2_tpu_torch.utils.transforms import side_resize_dims

    nh, nw = side_resize_dims(h, w, res)
    sd, td = (vae_cfg.spatial_downsample_factor,
              vae_cfg.temporal_downsample_factor)
    return ((t - 1) // td + 1, -(-nh // 16) * 16 // sd,
            -(-nw // 16) * 16 // sd)


def check_k1(torch, fa, nadit, cfg, device, path_latents):
    """K1 against its plain version: window lengths 128, 896 and 3712 with
    random tables, and every window group of the 720p clip plan with its
    real tables (all timed), then every group of the throughput requests'
    plans `path_latents` (checked, untimed). Returns the record of the clip
    plan's largest group."""
    import torch.nn.functional as F

    gen = torch.Generator(device).manual_seed(1)
    H, D, eps = cfg.heads, cfg.head_dim, cfg.norm_eps
    worst = 0.0
    cases = []
    for s, b in ((128, 16), (896, 4), (3712, 2)):
        for kv in (s - 37, s):
            cq, sq = rope_tables(torch, gen, s, D, device)
            ck, sk = rope_tables(torch, gen, s, D, device)
            cases.append((f"S={s} kv_len={kv} B={b}", b, s, kv,
                          (cq, sq, ck, sk), True))
    ones = torch.ones(D, device=device)
    main = None
    for label, shape in (("clip plan", (2, 90, 160)), *path_latents):
        timed = label == "clip plan"
        dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, shape, TXT_LEN),
                                  cfg, device)
        for method, groups in dplan.groups.items():
            for g in groups:
                tabs = nadit._fold_norm_tables(g.cos, g.sin, ones, ones, ones,
                                               ones, g.wlen, g.skv)
                case = (f"{label} {method} n={g.n} wlen={g.wlen} "
                        f"S={g.sk_pad} kv_len={g.skv}", g.n, g.sk_pad, g.skv,
                        tabs, timed)
                cases.append(case)
                if timed and (main is None or
                              g.n * g.sk_pad ** 2 > main[1] * main[2] ** 2):
                    main = case
    for case in cases:
        name, b, s, kv, tabs, timed = case
        qkv = torch.randn(b, s, 3 * H * D, generator=gen, device=device).to(
            torch.bfloat16)
        out = fa.packed_window_attention(qkv, H, D, *tabs, eps, kv)
        torch.cuda.synchronize()
        ref = fa.packed_window_attention_plain(qkv, H, D, *tabs, eps, kv)
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all():
            fail(f"K1 {name}: non-finite output")
        if not torch.allclose(out.float(), ref.float(), atol=K1_ATOL,
                              rtol=K1_RTOL):
            fail(f"K1 {name}: max abs err {err} beyond atol/rtol {K1_ATOL}")
        worst = max(worst, err)
        if not timed:
            say(f"K1 {name}: max_abs_err {err:.6g} (atol=rtol={K1_ATOL})")
            continue
        ms = kernel_ms(torch, lambda: fa.packed_window_attention(
            qkv, H, D, *tabs, eps, kv), 20)
        plain_ms = kernel_ms(torch, lambda: fa.packed_window_attention_plain(
            qkv, H, D, *tabs, eps, kv), 10)
        q, k, v, mask = sdpa_inputs(torch, qkv, H, D, tabs, eps, kv)
        lib_ms = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 20)
        flops = 4 * b * H * s * kv * D  # QK^T and PV over the kv_len keys
        nbytes = qkv.numel() * 2 + 4 * s * D * 4 + b * s * H * D * 2
        bound, by = bound_ms(flops, PEAK_BF16, nbytes)
        say(f"K1 {name}: max_abs_err {err:.6g} (atol=rtol={K1_ATOL}); "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, sdpa (attention core only) "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        if case is main:
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by)
    say(f"K1 worst max_abs_err over all cases {worst:.6g}; the record "
        f"below holds {main[0]}")
    return rec


def check_k2(torch, gather, nadit, cfg, device, path_latents):
    """K2 on the transitions of the clip plan and of the throughput
    requests' plans: exact. Times the clip plan's last transition."""
    gen = torch.Generator(device).manual_seed(2)
    errs = []
    for shape in [s for _, s in path_latents] + [(2, 90, 160)]:
        plan = nadit.build_dit_plan(cfg, shape, TXT_LEN)
        for key in (("canonical", "window"), ("window", "shifted_window")):
            index = gather.RowIndex(plan.transitions[key], device)
            x = torch.randn(1, plan.seq_len, cfg.vid_dim, generator=gen,
                            device=device).to(torch.bfloat16)
            out = gather.gather_rows(x, index)
            torch.cuda.synchronize()
            ref = gather.gather_rows_plain(x, index)
            if not torch.equal(out, ref):
                fail(f"K2 {key} L={plan.seq_len}: kernel output differs "
                     "from the plain gather")
            errs.append((out.float() - ref.float()).abs().max().item())
            say(f"K2 transition {key[0]}->{key[1]} L={plan.seq_len} "
                f"D={cfg.vid_dim}: exact")
    ms = kernel_ms(torch, lambda: gather.gather_rows(x, index), 50)
    plain_ms = kernel_ms(torch, lambda: gather.gather_rows_plain(x, index), 50)
    idx = index.tensor.long()
    lib_ms = kernel_ms(torch, lambda: torch.index_select(x, 1, idx), 50)
    warm_ms = cuda_ms(torch, lambda: gather.gather_rows(x, index), 50)
    nbytes = 2 * x.numel() * 2 + len(index) * 4
    bound, by = bound_ms(0, PEAK_BF16, nbytes)
    say(f"K2 timing: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s), "
        f"plain {plain_ms:.4f} ms, torch.index_select {lib_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({by}); back-to-back warm-L2 loop "
        f"{warm_ms:.4f} ms")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


def check_k3(torch, im, cfg, device, path_rows):
    """K3 bit-exact against its plain version at every shape the 3B w8a8
    DiT gives it on the throughput path: the video GEMMs at each request's
    token count `path_rows` [(label, M)], the text rows and the time
    embedding's single row. The record holds the first request's gate+up."""
    D, hidden = cfg.vid_dim, 6912
    shapes = []
    for label, m in path_rows:
        shapes += [(f"{label} qkv", m, 3 * D, D),
                   (f"{label} gate+up", m, 2 * hidden, D),
                   (f"{label} mlp out", m, D, hidden),
                   (f"{label} attn out", m, D, D)]
    shapes += [("txt_in", TXT_LEN, D, 5120), ("emb proj_hid", 1, D, D),
               ("emb proj_out", 1, 6 * D, D)]
    gen = torch.Generator(device).manual_seed(3)
    rec = None
    for name, m, n, k in shapes:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                           dtype=torch.int8)
        xs = torch.rand(m, generator=gen, device=device) * 0.01
        ws = torch.rand(n, generator=gen, device=device) * 0.01
        out = im.int8_matmul(xq, wq, xs, ws)
        torch.cuda.synchronize()
        ref = im.int8_matmul_plain(xq, wq, xs, ws)
        if not torch.equal(out, ref):
            bad = (out != ref).sum().item()
            fail(f"K3 {name} M={m} N={n} K={k}: {bad} entries differ from "
                 "the plain version")
        ms = kernel_ms(torch, lambda: im.int8_matmul(xq, wq, xs, ws), 20)
        plain_ms = kernel_ms(torch, lambda: im.int8_matmul_plain(
            xq, wq, xs, ws), 5)
        lib_ms = None
        if m > 16:  # torch._int_mm takes M > 16
            wt = wq.t()
            try:  # a yardstick only: the port never calls it
                lib_ms = kernel_ms(torch, lambda: torch._int_mm(xq, wt), 20)
            except RuntimeError as e:
                say(f"K3 {name}: torch._int_mm refused: {e}")
        ops = 2 * m * n * k
        nbytes = m * k + n * k + 4 * (m + n) + 2 * m * n
        bound, by = bound_ms(ops, PEAK_INT8, nbytes)
        say(f"K3 {name} M={m} N={n} K={k}: exact; kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, "
            f"torch._int_mm (int32 product only, no epilogue) "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound:.4f} ms ({by})")
        if rec is None and name.endswith("gate+up"):
            rec = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by)
    return rec


def q_error(torch, out, ref, name):
    """Max |q - q_plain|, failing beyond the stated tolerance."""
    diff = (out.q.int() - ref.q.int()).abs()
    worst = diff.max().item()
    equal = (diff == 0).float().mean().item()
    if worst > Q_MAX_DIFF or equal < Q_EQUAL_SHARE:
        fail(f"{name}: q off by up to {worst}, {equal:.6f} equal (needs "
             f"<= {Q_MAX_DIFF} and >= {Q_EQUAL_SHARE})")
    if not torch.allclose(out.s, ref.s, rtol=S_RTOL, atol=0):
        fail(f"{name}: scales beyond rtol {S_RTOL}")
    return worst, equal


def check_k4_k5(torch, fq, cfg, device, path_rows):
    """K4 on 2560-wide rows and K5 on 6912-wide halves of a gate+up
    product, at the text length and at each throughput request's token
    count `path_rows` [(label, M)]; the records hold the first request."""
    gen = torch.Generator(device).manual_seed(4)
    D, hidden = cfg.vid_dim, 6912
    lengths = [m for _, m in path_rows]
    recs = {}
    for l in lengths + [TXT_LEN]:
        x = torch.randn(1, l, D, generator=gen, device=device).to(
            torch.bfloat16)
        scale = 1 + 0.2 * torch.randn(1, D, generator=gen, device=device)
        shift = 0.2 * torch.randn(1, D, generator=gen, device=device)
        out = fq.rms_ada_quantize(x, scale, shift, cfg.norm_eps)
        torch.cuda.synchronize()
        ref = fq.rms_ada_quantize_plain(x, scale, shift, cfg.norm_eps)
        worst, equal = q_error(torch, out, ref, f"K4 L={l}")
        ms = kernel_ms(torch, lambda: fq.rms_ada_quantize(
            x, scale, shift, cfg.norm_eps), 50)
        plain_ms = kernel_ms(torch, lambda: fq.rms_ada_quantize_plain(
            x, scale, shift, cfg.norm_eps), 20)
        m = l
        nbytes = m * D * 2 + 2 * D * 4 + m * D + 4 * m
        bound, by = bound_ms(K4_OPS_PER_ELEM * m * D, PEAK_FP32, nbytes)
        say(f"K4 rows={m} K={D}: q max diff {worst}, {equal * 100:.4f} % "
            f"equal; kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s), "
            f"plain {plain_ms:.4f} ms, library none, bound {bound:.4f} ms "
            f"({by})")
        recs.setdefault("K4", dict(
            max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound, bound_by=by))
    for l in lengths + [TXT_LEN]:
        gu = torch.randn(1, l, 2 * hidden, generator=gen, device=device).to(
            torch.bfloat16)
        g, u = gu[..., :hidden], gu[..., hidden:]
        out = fq.silu_mul_quantize(g, u)
        torch.cuda.synchronize()
        ref = fq.silu_mul_quantize_plain(g, u)
        worst, equal = q_error(torch, out, ref, f"K5 L={l}")
        ms = kernel_ms(torch, lambda: fq.silu_mul_quantize(g, u), 50)
        plain_ms = kernel_ms(torch, lambda: fq.silu_mul_quantize_plain(g, u),
                             20)
        m = l
        nbytes = 2 * m * hidden * 2 + m * hidden + 4 * m
        bound, by = bound_ms(K5_OPS_PER_ELEM * m * hidden, PEAK_FP32, nbytes)
        say(f"K5 rows={m} K={hidden}: q max diff {worst}, "
            f"{equal * 100:.4f} % equal; kernel {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, "
            f"library none, bound {bound:.4f} ms ({by})")
        recs.setdefault("K5", dict(
            max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound, bound_by=by))
    return recs


def grid_of(tiles):
    """'rows x cols of h x w px' for a list of (y, x, h, w) rectangles."""
    if not tiles:
        return "untiled"
    ys = sorted({t[0] for t in tiles})
    xs = sorted({t[1] for t in tiles})
    return f"{len(ys)}x{len(xs)} of {tiles[0][2]}x{tiles[0][3]} px"


def serve(torch, np, cli, runner, requests, device, embeds):
    """Serve (name, frames, resolution, expected shape) requests with the
    runner's VAE tiling; check shape, finiteness and range; print the tile
    grids, wall, phases and peak memory."""
    for name, frames, res, expect in requests:
        runner.vae.last_encode_tiles, runner.vae.last_decode_tiles = [], []
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out, timings = cli.process_frames(runner, frames, embeds,
                                          resolution=res, seed=42)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        finite = bool(np.isfinite(out).all())
        say(f"request {name}: out {out.shape} finite={finite} "
            f"range [{out.min():.4f}, {out.max():.4f}]; encode tiles "
            f"{grid_of(runner.vae.last_encode_tiles)}, decode tiles "
            f"{grid_of(runner.vae.last_decode_tiles)}; wall "
            f"{wall:.3f} s phases " + ", ".join(
                f"{k} {v:.4f} s" for k, v in timings.items())
            + f"; peak device memory {peak:.2f} GiB")
        if out.shape != expect or not finite:
            fail(f"request {name}: expected finite {expect}, got {out.shape}")
        if out.min() < 0.0 or out.max() > 1.0 or out.std() < 1e-3:
            fail(f"request {name}: output outside [0, 1] or degenerate")


def reset_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counts(wrappers, needed, path):
    counts = {k: w.launches for k, w in wrappers.items()}
    say(f"launches during the {path} path: {counts}")
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        fail(f"kernels {missing} of the {path} path were never launched")
    return counts


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "seedvr2_tpu_torch")):
        fail("the seedvr2_tpu_torch package is not next to chip_smoke.py")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    from seedvr2_tpu_torch import cli
    from seedvr2_tpu_torch.core import pipeline
    from seedvr2_tpu_torch.core.configs import DIT_3B, VAE_V3
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.ops import _build, gather
    from seedvr2_tpu_torch.ops import flash_attention as fa
    from seedvr2_tpu_torch.ops import fused_quant as fq
    from seedvr2_tpu_torch.ops import int8_matmul as im
    from seedvr2_tpu_torch.profile_requests import make_frames
    from seedvr2_tpu_torch.utils.text_embeds import load_text_embeddings

    wrappers = {"K1": fa.packed_window_attention, "K2": gather.gather_rows,
                "K3": im.int8_matmul, "K4": fq.rms_ada_quantize,
                "K5": fq.silu_mul_quantize}

    # 1. environment and build
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    lib = _build.kernel_library()
    say(f"kernels built in {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.ptxas_log.splitlines():  # per-kernel resource report
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say(f"  {line.strip()}")

    # 2. kernels against their plain versions at 3B shapes, among them the
    # token counts of the throughput requests served in phase 5
    path_latents = [(label, latent_shape(VAE_V3, t, h, w, res))
                    for label, t, h, w, res in FAST_REQUESTS]
    path_rows = [(label, nadit.build_dit_plan(DIT_3B, shape,
                                              TXT_LEN).seq_len)
                 for label, shape in path_latents]
    say(f"throughput requests' latents {path_latents}, DiT rows {path_rows}")
    recs = {"K1": check_k1(torch, fa, nadit, DIT_3B, device, path_latents),
            "K2": check_k2(torch, gather, nadit, DIT_3B, device,
                           path_latents),
            "K3": check_k3(torch, im, DIT_3B, device, path_rows)}
    recs.update(check_k4_k5(torch, fq, DIT_3B, device, path_rows))

    # 3. the default path: three requests at full width
    t0 = time.perf_counter()
    runner = cli.make_runner(device, seed=0)
    torch.cuda.synchronize()
    n_dit = sum(p.numel() for p in runner.dit.parameters())
    n_vae = sum(p.numel() for p in runner.vae.model.parameters())
    say(f"models built on the card in {time.perf_counter() - t0:.2f} s: "
        f"DiT {n_dit / 1e9:.3f} B params ({DIT_3B.num_layers} layers, width "
        f"{DIT_3B.vid_dim}), VAE {n_vae / 1e6:.1f} M params, bf16")
    embeds = load_text_embeddings(txt_dim=DIT_3B.txt_in_dim)
    if embeds["pos"].shape[0] != TXT_LEN:
        fail(f"positive text embedding has {embeds['pos'].shape[0]} tokens, "
             f"the kernel checks assumed {TXT_LEN}")
    image = make_frames(1, 360, 640, seed=3)
    clip = make_frames(5, 360, 640, seed=4)
    reset_counts(wrappers)
    serve(torch, np, cli, runner, (
        ("image 1x360x640 -> 720", image, 720, (1, 720, 1280, 3)),
        ("clip 5x360x640 -> 720", clip, 720, (5, 720, 1280, 3)),
        ("clip again", clip, 720, (5, 720, 1280, 3))), device, embeds)
    default_counts = read_counts(wrappers, ("K1", "K2"), "default")

    # 4. whole DiT, kernels against plain versions, on the clip's latent
    txt = torch.as_tensor(embeds["pos"], dtype=torch.bfloat16,
                          device=device)[None]
    tt = torch.full((1,), 1000.0, device=device)

    def dit_inputs(r, frames, res):
        """The DiT's input for one request encoded by runner r (noise from
        a seed beside the condition) and its plan."""
        ctx = pipeline.setup_generation_context(device)
        ctx = pipeline.encode_all_batches(r, ctx, frames, resolution=res)
        latent = ctx["all_latents"][0]
        gen = torch.Generator(device).manual_seed(42)
        noise = torch.randn(latent.shape, generator=gen, device=device).to(
            torch.bfloat16)
        vid_in = torch.cat([noise, r.get_condition(noise, latent)], -1)[None]
        return vid_in, r.plan(tuple(latent.shape[:3]), txt.shape[1])

    def dit_runs(model, label, vid_in, dplan, limit):
        """Outputs {use_kernels: out} of one forward each, relative L2 of
        kernels against plain versions held to `limit`."""
        outs, ms = {}, {}
        with torch.no_grad():
            for uk in (True, False):
                fwd = (lambda uk=uk: nadit.nadit_forward(
                    model, vid_in, txt, tt, dplan, use_kernels=uk))
                outs[uk] = fwd()
                ms[uk] = cuda_ms(torch, fwd, 3, warmup=1)
        rel = rel_l2(outs[True], outs[False])
        say(f"whole {label} DiT on latent {dplan.plan.vid_shape} "
            f"({dplan.plan.seq_len} tokens): relative L2 kernels vs plain "
            f"{rel:.6g} (bound {limit}); forward {ms[True]:.2f} ms with "
            f"kernels, {ms[False]:.2f} ms plain")
        if not torch.isfinite(outs[True]).all() or rel > limit:
            fail(f"whole {label} DiT kernels vs plain: relative L2 {rel} > "
                 f"{limit}")
        return outs, rel

    vid_in, dplan = dit_inputs(runner, clip, 720)
    if dplan.plan.vid_shape != latent_shape(VAE_V3, 5, 360, 640, 720):
        fail(f"latent_shape disagrees with the encoded clip "
             f"{dplan.plan.vid_shape}")
    dit_runs(runner.dit, "bf16", vid_in, dplan, DIT_REL_L2)

    # 5. the throughput path: the same weights in w8a8, tiled VAE
    args = cli.parse_arguments(["unused.npy", "--preset", "throughput"])
    tiling = cli.tiling_from_args(args)
    t0 = time.perf_counter()
    fast = cli.make_runner(device, seed=0, quant=args.quant, tiling=tiling)
    torch.cuda.synchronize()
    w8 = [m for m in fast.dit.modules() if isinstance(m, im.W8A8Linear)]
    w8_bytes = sum(m.w8a8.numel() + m.ws.numel() * 4 for m in w8)
    dense_bytes = sum(p.numel() * p.element_size()
                      for p in fast.dit.parameters())
    say(f"w8a8 DiT built and converted in {time.perf_counter() - t0:.2f} s: "
        f"{len(w8)} linears int8 ({w8_bytes / 2 ** 30:.3f} GiB), "
        f"{dense_bytes / 2 ** 30:.3f} GiB left in bf16; tiling {tiling}")
    fast_frames = [make_frames(t, h, w, seed=5 + i)
                   for i, (_, t, h, w, _) in enumerate(FAST_REQUESTS)]
    fast_inputs = []
    for (label, shape), frames, (*_, res) in zip(path_latents, fast_frames,
                                                 FAST_REQUESTS):
        fast_inputs.append(dit_inputs(fast, frames, res))
        if fast_inputs[-1][1].plan.vid_shape != shape:
            fail(f"{label}: encoded latent {fast_inputs[-1][1].plan.vid_shape}"
                 f" is not the {shape} the kernel checks used")
    # the whole w8a8 DiT on the 1080p clip's latent, against its plain
    # versions and against the bf16 DiT on the same weights
    vid_in, dplan = fast_inputs[0]
    w8_outs, w8_rel = dit_runs(fast.dit, "w8a8", vid_in, dplan,
                               W8A8_DIT_REL_L2)
    with torch.no_grad():
        dense = nadit.nadit_forward(runner.dit, vid_in, txt, tt, dplan)
        dense_plain = nadit.nadit_forward(runner.dit, vid_in, txt, tt, dplan,
                                          use_kernels=False)
    to_dense = rel_l2(w8_outs[True], dense)
    gap_plain = rel_l2(w8_outs[False], dense_plain)
    say(f"w8a8 against bf16 DiT, same weights, same latent: relative L2 "
        f"{to_dense:.6g} with kernels, {gap_plain:.6g} plain; w8a8 kernels "
        f"vs w8a8 plain {w8_rel:.6g} must be the smaller")
    if not w8_rel < to_dense:
        fail(f"the w8a8 DiT with kernels is no closer to its plain w8a8 "
             f"version ({w8_rel}) than to the bf16 DiT ({to_dense})")
    del runner, fast_inputs, vid_in, dplan, w8_outs, dense, dense_plain
    torch.cuda.empty_cache()

    requests = []
    for (label, t, h, w, res), frames in zip(FAST_REQUESTS, fast_frames):
        expect = (t, res, res * w // h, 3)
        requests.append((label, frames, res, expect))
    requests += [(f"{label} again", *rest) for label, *rest in requests]
    reset_counts(wrappers)
    serve(torch, np, cli, fast, requests, device, embeds)
    fast_counts = read_counts(wrappers, tuple(KERNELS), "throughput")

    # 6. records and the contract line
    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        by_path = {"default": default_counts[key],
                   "throughput": fast_counts[key]}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=(by_path["default"] if key in ("K1", "K2")
                      else by_path["throughput"]),
            launches_by_path=by_path, **recs[key]))
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
