"""Times the port's normalisation kernels on one GPU: the fused norm + SiLU +
causal head K12 (`norm_silu_head_ncdhw`) at every shape of the 720p clip's
fused-norm encode and decode, the w8a8 lane's producers K4
(`rms_ada_quantize`) and K5 (`silu_mul_quantize`) at the 1080p clip's and
4K image's DiT rows and the text rows, the whole fused-norm VAE encode and
decode of the 720p clip, and the whole 32-layer w8a8 DiT forward at the
1080p clip's latent (the grouped plan, as served).

    python seedvr2_tpu_torch/ab_norm.py [--root DIR] [--iters 20]

`--root` names the checkout whose `seedvr2_tpu_torch` is imported (default:
the one this file lies in), so one command can time two trees in turns,
each in its own process (parent, change, change, parent). Everything is
drawn from seeds on the card: activations, modulation rows, bf16 DiT and
VAE weights (`init_dit`, `init_vae_params`), frames, latents, text rows.
Kernels: each call timed alone with CUDA events after a 256 MB write that
evicts the L2, the mean of `--iters`; at the 58 text rows also the device
time from a torch.profiler trace, which leaves out the host's launch cost.
K4 and K5 print a digest of their output, so two trees' outputs can be
compared bit for bit. Encode, decode and forward: CUDA events around 3
back-to-back calls after one warm-up, with the kernel's launches in one
call. Prints the card's name and power limit, the tree, then one line a
measurement. Needs a CUDA device.
"""

import argparse
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TXT_LEN = 58
# K4 / K5: the DiT rows of the 1080p clip (latent 2 x 136 x 240) and of
# the 4K image (1 x 270 x 480), and the text rows
ROWS = (16320, 32400, TXT_LEN)
DIT_LATENT = (2, 136, 240)   # the 1080p clip (5 x 540 x 960)
VAE_FRAMES = (5, 720, 1280)  # the 720p clip's encoder input
VAE_LATENT = (2, 90, 160)    # and its latent


def _device_ms(torch, fn, iters: int, flush) -> float:
    """Device milliseconds of the kernels one call of fn() launches, from a
    torch.profiler trace (the flush's own fill left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not any(w in e.name.lower() for w in ("fill", "memset")))
    return us / iters / 1e3


def _digest(torch, *tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(HERE))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [d for d in sys.path if os.path.abspath(d or ".")
                            != HERE]
    os.environ["SEEDVR2_FUSED_NORM"] = "1"  # read when a VAE is built
    import torch

    from chip_smoke import K12_SHAPES  # every fused norm of the 720p clip
    from seedvr2_tpu_torch.ab_int8 import _kernel_ms, _whole_ms
    from seedvr2_tpu_torch.core.configs import DIT_3B, VAE_V3
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.models.vae.pipeline_vae import (VideoVAE,
                                                           init_vae_params)
    from seedvr2_tpu_torch.ops import fused_norm as fn
    from seedvr2_tpu_torch.ops import fused_quant as fq
    from seedvr2_tpu_torch.ops import int8_matmul as im

    if not torch.cuda.is_available():
        raise SystemExit("ab_norm: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"tree {root}", flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(dev).manual_seed(0)

    for c, t, h, w in K12_SHAPES:
        x = torch.randn(1, c, t, h, w, generator=gen, device=dev).to(
            torch.bfloat16)
        wt = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        bs = 0.1 * torch.randn(c, generator=gen, device=dev)
        ms = _kernel_ms(torch, lambda: fn.norm_silu_head_ncdhw(
            x, wt, bs, 32), max(2, args.iters // 2), flush)
        print(f"K12 C={c} T={t} {h}x{w}: {ms:.4f} ms", flush=True)
        del x

    k, hidden = DIT_3B.vid_dim, 6912
    for rows in ROWS:
        x = torch.randn(1, rows, k, generator=gen, device=dev).to(
            torch.bfloat16)
        scale = 1 + 0.2 * torch.randn(1, k, generator=gen, device=dev)
        shift = 0.2 * torch.randn(1, k, generator=gen, device=dev)
        gu = torch.randn(1, rows, 2 * hidden, generator=gen, device=dev).to(
            torch.bfloat16)
        g, u = gu[..., :hidden], gu[..., hidden:]
        for name, call in (
                (f"K4 rows={rows} K={k}",
                 lambda: fq.rms_ada_quantize(x, scale, shift, 1e-5)),
                (f"K5 rows={rows} K={hidden}",
                 lambda: fq.silu_mul_quantize(g, u))):
            out = call()
            ms = _kernel_ms(torch, call, args.iters, flush)
            dev_ms = ("" if rows != TXT_LEN else
                      f", device {_device_ms(torch, call, 10, flush):.4f} ms")
            print(f"{name}: {ms:.4f} ms{dev_ms}, output digest "
                  f"{_digest(torch, out.q, out.s)}", flush=True)
        del x, gu, g, u

    vcfg = VAE_V3
    vae = VideoVAE(init_vae_params(vcfg, dev, torch.bfloat16, generator=gen),
                   torch.bfloat16)
    if not vae.lowering.fused_norm:
        raise SystemExit("ab_norm: SEEDVR2_FUSED_NORM=1 did not reach the VAE")
    frames = (torch.rand(1, *VAE_FRAMES, 3, generator=gen, device=dev) * 2
              - 1).to(torch.bfloat16)
    z = torch.randn(1, *VAE_LATENT, vcfg.latent_channels, generator=gen,
                    device=dev).to(torch.bfloat16)
    for what, call in (("encode", lambda: vae.encode(frames)),
                       ("decode", lambda: vae.decode(z))):
        def run(call=call):
            with torch.no_grad():
                return call()

        ms, n12 = _whole_ms(torch, run, fn.norm_silu_head)
        print(f"fused-norm VAE {what} 720p clip: {ms:.2f} ms, {n12} K12 "
              "launches", flush=True)
    del vae, frames, z
    torch.cuda.empty_cache()

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

    ms, n4 = _whole_ms(torch, forward, fq.rms_ada_quantize)
    print(f"w8a8 DiT forward {DIT_LATENT} grouped plan: {ms:.2f} ms, {n4} K4 "
          "launches", flush=True)


if __name__ == "__main__":
    main()
