"""Times the port's int8 kernels on one GPU: the w8a8 GEMM K3
(`int8_matmul`) at every shape the 3B w8a8 DiT gives it on the throughput
path, the int8 conv K11 (`int8_conv3d_ncdhw`) at every shape of the 720p
clip's int8 decode, the whole 32-layer w8a8 DiT forward at the 1080p clip's
latent (the grouped plan, as served), and the whole int8 VAE decode of the
720p clip's latent.

    python seedvr2_tpu_torch/ab_int8.py [--root DIR] [--iters 20]

`--root` names the checkout whose `seedvr2_tpu_torch` is imported (default:
the one this file lies in), so one command can time two trees in turns,
each in its own process (parent, change, change, parent). Everything is
drawn from seeds on the card: int8 operands and scales, bf16 DiT and VAE
weights (`init_dit`, `init_vae_params`), latents, text rows. Kernels: each
call timed alone with CUDA events after a 256 MB write that evicts the L2,
the mean of `--iters`. Forward and decode: CUDA events around 3
back-to-back calls after one warm-up, with the kernel's launches in one
call. Prints the card's name and power limit, the tree, then one line a
measurement. Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TXT_LEN = 58
# K3: the DiT rows of the throughput path's requests (chip_smoke.py's
# FAST_REQUESTS: the 1080p clip, latent 2 x 136 x 240, and the 4K image,
# 1 x 270 x 480), the text rows and the time embedding's single row;
# (label, M, N, K) as chip_smoke.py's check_k3 builds them
K3_ROWS = (("clip 5x540x960 -> 1080", 16320),
           ("image 1x1080x1920 -> 2160", 32400))
K3_SHAPES = tuple(
    (f"{label} {name}", m, n, k) for label, m in K3_ROWS
    for name, n, k in (("qkv", 7680, 2560), ("gate+up", 13824, 2560),
                       ("mlp out", 2560, 6912), ("attn out", 2560, 2560))
) + (("txt_in", TXT_LEN, 2560, 5120), ("emb proj_hid", 1, 2560, 2560),
     ("emb proj_out", 1, 15360, 2560))
# K11: (Ci, Co, T, H, W) of every int8 conv of the 720p clip's decode, as
# chip_smoke.py's K11_SHAPES
K11_SHAPES = ((512, 512, 2, 90, 160), (512, 512, 3, 180, 320),
              (512, 256, 5, 360, 640), (256, 256, 5, 360, 640),
              (256, 128, 5, 720, 1280), (128, 128, 5, 720, 1280))
DIT_LATENT = (2, 136, 240)   # the 1080p clip (5 x 540 x 960)
VAE_LATENT = (2, 90, 160)    # the 720p clip (5 x 360 x 640)


def _kernel_ms(torch, fn, iters: int, flush) -> float:
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _whole_ms(torch, fn, counter, reps: int = 3):
    """(ms a call over `reps` back-to-back calls after one warm-up, the
    counter's launches in one call)."""
    before = counter.launches
    fn()
    torch.cuda.synchronize()
    launches = counter.launches - before
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return a.elapsed_time(e) / reps, launches


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(HERE))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [d for d in sys.path if os.path.abspath(d or ".")
                            != HERE]
    import dataclasses

    import torch

    from seedvr2_tpu_torch.core.configs import DIT_3B, VAE_V3
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.models.vae.pipeline_vae import (VideoVAE,
                                                           init_vae_params)
    from seedvr2_tpu_torch.ops import int8_conv as ic
    from seedvr2_tpu_torch.ops import int8_matmul as im

    if not torch.cuda.is_available():
        raise SystemExit("ab_int8: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"tree {root}", flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(dev).manual_seed(0)

    for name, m, n, k in K3_SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        xs = torch.rand(m, generator=gen, device=dev) * 0.01
        ws = torch.rand(n, generator=gen, device=dev) * 0.01
        ms = _kernel_ms(torch, lambda: im.int8_matmul(xq, wq, xs, ws),
                        args.iters, flush)
        print(f"K3 {name} M={m} N={n} K={k}: {ms:.4f} ms", flush=True)
        del xq, wq

    for ci, co, t, h, w in K11_SHAPES:
        wp = -(-(w + 2) // 32) * 32
        x_ext = torch.randint(-127, 128, (t + 2, h + 2, wp, ci),
                              generator=gen, device=dev, dtype=torch.int8)
        wk = torch.randint(-127, 128, (co, 27 * ci), generator=gen,
                           device=dev, dtype=torch.int8)
        xs = torch.rand(t, generator=gen, device=dev) * 0.01
        ws = torch.rand(co, generator=gen, device=dev) * 0.01
        bias = (0.1 * torch.randn(co, generator=gen, device=dev)).to(
            torch.bfloat16)
        ms = _kernel_ms(torch, lambda: ic.int8_conv3d_ncdhw(
            x_ext, wk, xs, ws, bias, w), max(2, args.iters // 2), flush)
        print(f"K11 Ci={ci} Co={co} T={t} {h}x{w}: {ms:.4f} ms", flush=True)
        del x_ext, wk

    cfg = DIT_3B
    model = im.quantize_dit_w8a8(nadit.init_dit(cfg, dev, torch.bfloat16,
                                                generator=gen))
    vid = torch.randn(1, *DIT_LATENT, cfg.vid_in_channels, generator=gen,
                      device=dev).to(torch.bfloat16)
    txt = torch.randn(1, TXT_LEN, cfg.txt_in_dim, generator=gen,
                      device=dev).to(torch.bfloat16)
    tt = torch.full((1,), 1000.0, device=dev)
    dplan = nadit.upload_plan(nadit.build_dit_plan(cfg, DIT_LATENT, TXT_LEN),
                              cfg, dev)

    def forward():
        with torch.no_grad():
            return nadit.nadit_forward(model, vid, txt, tt, dplan)

    ms, n3 = _whole_ms(torch, forward, im.int8_matmul)
    print(f"w8a8 DiT forward {DIT_LATENT} grouped plan: {ms:.2f} ms, "
          f"{n3} K3 launches", flush=True)
    del model, vid, txt, dplan
    torch.cuda.empty_cache()

    vcfg = dataclasses.replace(VAE_V3, conv_quant="int8")
    vae = VideoVAE(init_vae_params(vcfg, dev, torch.bfloat16, generator=gen),
                   torch.bfloat16)
    z = torch.randn(1, *VAE_LATENT, vcfg.latent_channels, generator=gen,
                    device=dev).to(torch.bfloat16)

    def decode():
        with torch.no_grad():
            return vae.decode(z)

    ms, n11 = _whole_ms(torch, decode, ic.int8_conv3d)
    print(f"int8 VAE decode {VAE_LATENT}: {ms:.2f} ms, {n11} K11 launches",
          flush=True)


if __name__ == "__main__":
    main()
