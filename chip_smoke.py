#!/usr/bin/env python3
"""Smoke run of the PyTorch port (seedvr2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU, `nvcc` and no
network. In order it:

 1. prints the card (nvidia-smi name and power limit), the torch and CUDA
    versions, and builds the hand-written kernels from csrc/ (nvcc time);
 2. holds each kernel against its plain PyTorch version at 3B shapes on the
    card, K1 (packed window attention) within bf16 tolerance, K2 (row
    gather) exactly, and times both sides with CUDA events;
 3. builds the 3B DiT (32 layers, width 2560) and VAE_V3 with random weights
    drawn on the card from a seed, and serves three requests through the
    port's `process_frames` (a 360x640 image to 720p, a 5-frame 360x640 clip
    to 720p, the clip again), checking shapes and finiteness and that K1 and
    K2 were launched by that main path;
 4. runs the whole 32-layer DiT once with the kernels and once with their
    plain versions on the clip's latent and bounds the relative L2 error;
 5. prints the kernels' JSON record, the card line again, and last
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
# whole 32-layer DiT, kernels vs plain versions: per-layer bf16-class
# differences of the attention output propagate through 32 residual blocks
# of a random-weight model; bounded as a bf16-class relative L2 error.
DIT_REL_L2 = 2e-2

K1_SOURCE = "seedvr2_tpu_torch/csrc/packed_attention.cu"
K1_REPLACES = "comfyui-seedvr2_tpu/ops/flash_attention.py:224"
K2_SOURCE = "seedvr2_tpu_torch/csrc/gather_rows.cu"
K2_REPLACES = "comfyui-seedvr2_tpu/ops/gather.py:70"


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
    """Mean milliseconds per call of fn() over `iters` calls, CUDA events."""
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


def rope_tables(torch, gen, s: int, d: int, device):
    ang = torch.randn(s, d // 2, generator=gen, device=device)
    return (torch.cos(ang).repeat_interleave(2, -1).contiguous(),
            torch.sin(ang).repeat_interleave(2, -1).contiguous())


def check_k1(torch, fa, nadit, cfg, device):
    """K1 against its plain version: window lengths 128, 896 and 3712 with
    random tables, and every window group of the 720p clip plan with its
    real tables. Returns (max abs error, kernel ms, plain ms) at the clip
    plan's largest group."""
    gen = torch.Generator(device).manual_seed(1)
    H, D, eps = cfg.heads, cfg.head_dim, cfg.norm_eps
    worst = 0.0
    cases = []
    for s, b in ((128, 16), (896, 4), (3712, 2)):
        for kv in (s - 37, s):
            cq, sq = rope_tables(torch, gen, s, D, device)
            ck, sk = rope_tables(torch, gen, s, D, device)
            cases.append((f"S={s} kv_len={kv} B={b}", b, s, kv,
                          (cq, sq, ck, sk)))
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, (2, 90, 160), 58),
                              cfg, device)
    ones = torch.ones(D, device=device)
    main = None
    for method, groups in dplan.groups.items():
        for g in groups:
            tabs = nadit._fold_norm_tables(g.cos, g.sin, ones, ones, ones,
                                           ones, g.wlen, g.skv)
            case = (f"clip plan {method} n={g.n} wlen={g.wlen} S={g.sk_pad} "
                    f"kv_len={g.skv}", g.n, g.sk_pad, g.skv, tabs)
            cases.append(case)
            if main is None or g.n * g.sk_pad ** 2 > main[1] * main[2] ** 2:
                main = case
    for case in cases:
        name, b, s, kv, tabs = case
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
        ms = cuda_ms(torch, lambda: fa.packed_window_attention(
            qkv, H, D, *tabs, eps, kv), 20)
        plain_ms = cuda_ms(torch, lambda: fa.packed_window_attention_plain(
            qkv, H, D, *tabs, eps, kv), 20)
        flops = 4 * b * H * s * s * D
        say(f"K1 {name}: max_abs_err {err:.6g} (atol=rtol={K1_ATOL}); "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms")
        if case is main:
            result = (err, ms, plain_ms)
    say(f"K1 worst max_abs_err over all cases {worst:.6g}; the record "
        f"below holds {main[0]}")
    return result


def check_k2(torch, gather, nadit, cfg, device):
    """K2 on the clip plan's canonical->window transition: exact."""
    plan = nadit.build_dit_plan(cfg, (2, 90, 160), 58)
    gen = torch.Generator(device).manual_seed(2)
    errs = []
    for key in (("canonical", "window"), ("window", "shifted_window")):
        index = gather.RowIndex(plan.transitions[key], device)
        x = torch.randn(1, plan.seq_len, cfg.vid_dim, generator=gen,
                        device=device).to(torch.bfloat16)
        out = gather.gather_rows(x, index)
        torch.cuda.synchronize()
        ref = gather.gather_rows_plain(x, index)
        if not torch.equal(out, ref):
            fail(f"K2 {key}: kernel output differs from the plain gather")
        errs.append((out.float() - ref.float()).abs().max().item())
        say(f"K2 transition {key[0]}->{key[1]} L={plan.seq_len} "
            f"D={cfg.vid_dim}: exact")
    ms = cuda_ms(torch, lambda: gather.gather_rows(x, index), 50)
    plain_ms = cuda_ms(torch, lambda: gather.gather_rows_plain(x, index), 50)
    gbs = 2 * x.numel() * 2 / (ms * 1e-3) / 1e9
    say(f"K2 timing: kernel {ms:.4f} ms ({gbs:.0f} GB/s read+write), "
        f"plain {plain_ms:.4f} ms")
    return max(errs), ms, plain_ms


def make_frames(np, t: int, h: int, w: int, seed: int):
    """Smooth colour gradients plus noise in [0, 1], (t, h, w, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([yy, xx, 1 - 0.5 * (yy + xx)], -1)[None]
    frames = base + 0.05 * rng.standard_normal((t, h, w, 3))
    return np.clip(frames, 0, 1).astype(np.float32)


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
    from seedvr2_tpu_torch.core.configs import DIT_3B
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.ops import _build, gather
    from seedvr2_tpu_torch.ops import flash_attention as fa
    from seedvr2_tpu_torch.utils.text_embeds import load_text_embeddings

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

    # 2. kernels against their plain versions at 3B shapes
    k1_err, k1_ms, k1_plain_ms = check_k1(torch, fa, nadit, DIT_3B, device)
    k2_err, k2_ms, k2_plain_ms = check_k2(torch, gather, nadit, DIT_3B,
                                          device)

    # 3. three requests through the slice at full width
    t0 = time.perf_counter()
    runner = cli.make_runner(device, seed=0)
    torch.cuda.synchronize()
    n_dit = sum(p.numel() for p in runner.dit.parameters())
    n_vae = sum(p.numel() for p in runner.vae.model.parameters())
    say(f"models built on the card in {time.perf_counter() - t0:.2f} s: "
        f"DiT {n_dit / 1e9:.3f} B params ({DIT_3B.num_layers} layers, width "
        f"{DIT_3B.vid_dim}), VAE {n_vae / 1e6:.1f} M params, bf16")
    embeds = load_text_embeddings(txt_dim=DIT_3B.txt_in_dim)
    image = make_frames(np, 1, 360, 640, seed=3)
    clip = make_frames(np, 5, 360, 640, seed=4)
    requests = (("image 1x360x640 -> 720", image),
                ("clip 5x360x640 -> 720", clip),
                ("clip again", clip))
    fa.packed_window_attention.launches = 0
    gather.gather_rows.launches = 0
    for name, frames in requests:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out, timings = cli.process_frames(runner, frames, embeds,
                                          resolution=720, seed=42)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        expect = (frames.shape[0], 720, 1280, 3)
        finite = bool(np.isfinite(out).all())
        say(f"request {name}: out {out.shape} finite={finite} "
            f"range [{out.min():.4f}, {out.max():.4f}] wall {wall:.3f} s "
            f"phases " + ", ".join(f"{k} {v:.4f} s" for k, v in
                                   timings.items())
            + f"; peak device memory {peak:.2f} GiB")
        if out.shape != expect or not finite:
            fail(f"request {name}: expected finite {expect}, got {out.shape}")
        if out.min() < 0.0 or out.max() > 1.0 or out.std() < 1e-3:
            fail(f"request {name}: output outside [0, 1] or degenerate")
    launches = {"K1": fa.packed_window_attention.launches,
                "K2": gather.gather_rows.launches}
    say(f"launches during the three requests: {launches}")
    if min(launches.values()) == 0:
        fail("a kernel of the main path was never launched")

    # 4. whole DiT, kernels against plain versions, on the clip's latent
    ctx = pipeline.setup_generation_context(device)
    ctx = pipeline.encode_all_batches(runner, ctx, clip, resolution=720)
    latent = ctx["all_latents"][0]
    gen = torch.Generator(device).manual_seed(42)
    noise = torch.randn(latent.shape, generator=gen, device=device).to(
        torch.bfloat16)
    vid_in = torch.cat([noise, runner.get_condition(noise, latent)], -1)[None]
    txt = torch.as_tensor(embeds["pos"], dtype=torch.bfloat16,
                          device=device)[None]
    tt = torch.full((1,), 1000.0, device=device)
    dplan = runner.plan(tuple(latent.shape[:3]), txt.shape[1])
    outs, dit_ms = {}, {}
    with torch.no_grad():
        for use_kernels in (True, False):
            fwd = (lambda uk=use_kernels: nadit.nadit_forward(
                runner.dit, vid_in, txt, tt, dplan, use_kernels=uk))
            outs[use_kernels] = fwd()
            dit_ms[use_kernels] = cuda_ms(torch, fwd, 3, warmup=1)
    k, p = outs[True].float(), outs[False].float()
    rel = ((k - p).norm() / p.norm()).item()
    say(f"whole DiT on latent {tuple(latent.shape)}: relative L2 kernels vs "
        f"plain {rel:.6g} (bound {DIT_REL_L2}); forward {dit_ms[True]:.2f} ms "
        f"with kernels, {dit_ms[False]:.2f} ms plain")
    if not torch.isfinite(k).all() or rel > DIT_REL_L2:
        fail(f"whole-DiT kernels vs plain: relative L2 {rel} > {DIT_REL_L2}")

    # 5. records and the contract line
    kernels = [
        {"name": "packed_window_attention", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "gather_rows", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
