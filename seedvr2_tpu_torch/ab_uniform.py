"""Times the uniform window plan's kernel K9 (`flash_windowed_attention`) at
every uniform layer of the 720p and 1080p clips, the quantizing GEMM K10
(`int8_matmul_qx`) at the 1080p clip's DiT linears and at 58 and 1 rows,
and the whole 32-layer 3B DiT forward on the uniform and the grouped plans
at both clips' latents, with its peak device memory, on one GPU.

    python seedvr2_tpu_torch/ab_uniform.py [--root DIR] [--iters 20]

`--root` names the checkout whose `seedvr2_tpu_torch` is imported (default:
the one this file lies in), so one command can time two trees in turns,
each in its own process (parent, change, change, parent). Everything is
drawn from seeds on the card: bf16 DiT weights (`init_dit`), latents, text
rows, attention operands, GEMM operands. Kernels: each call timed alone
with CUDA events after a 256 MB write that evicts the L2, the mean of
`--iters`. Forwards: CUDA events around 5 back-to-back forwards after one
warm-up, and the peak of `torch.cuda.max_memory_allocated()` during one
forward above what was allocated before it. Prints the card's name and
power limit, the tree, then one line a measurement. Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TXT_LEN = 58
# the uniform plan's latents: 5-frame 360x640 -> 720p, 540x960 -> 1080p
LATENTS = (("720p clip", (2, 90, 160)), ("1080p clip", (2, 136, 240)))
# K10: (label, M, N, K), the 1080p clip's DiT linears and the text / time
# embedding rows
K10_SHAPES = (("qkv", 16320, 7680, 2560), ("gate+up", 16320, 13824, 2560),
              ("proj_out", 16320, 2560, 2560), ("mlp out", 16320, 2560, 6912),
              ("qkv", 58, 7680, 2560), ("qkv", 1, 7680, 2560))


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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(HERE))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [d for d in sys.path if os.path.abspath(d or ".")
                            != HERE]
    import torch

    from seedvr2_tpu_torch.core.configs import DIT_3B
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.ops import flash_attention as fa
    from seedvr2_tpu_torch.ops import int8_matmul as im

    if not torch.cuda.is_available():
        raise SystemExit("ab_uniform: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"tree {root}", flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    cfg = DIT_3B
    H, D = cfg.heads, cfg.head_dim

    for label, shape in LATENTS:
        dplan = nadit.upload_plan(nadit.build_dit_plan(
            cfg, shape, TXT_LEN, uniform=True), cfg, dev)
        for method, u in dplan.uniform.items():
            ids = u.batch_ids(1)
            b, s = len(ids), u.cos.shape[1]
            q, k, v = (torch.randn(b, s, H, D, generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(3))
            ms = _kernel_ms(torch, lambda: fa.flash_windowed_attention(
                q, k, v, None, u.cos, u.sin, ids, u.valid), args.iters,
                flush)
            print(f"K9 {label} {method} nW={b} nU={u.cos.shape[0]} S={s}: "
                  f"{ms:.4f} ms", flush=True)
            del q, k, v

    for name, m, n, k in K10_SHAPES:
        x = (3 * torch.randn(m, k, generator=gen, device=dev)).to(
            torch.bfloat16)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(n, generator=gen, device=dev) * 0.01
        ms = _kernel_ms(torch, lambda: im.int8_matmul_qx(x, wq, ws),
                        args.iters, flush)
        print(f"K10 {name} M={m} N={n} K={k}: {ms:.4f} ms", flush=True)
        del x, wq, ws

    model = nadit.init_dit(cfg, dev, torch.bfloat16, generator=gen)
    txt = torch.randn(1, TXT_LEN, cfg.txt_in_dim, generator=gen,
                      device=dev).to(torch.bfloat16)
    t = torch.full((1,), 1000.0, device=dev)
    for label, shape in LATENTS:
        vid = torch.randn(1, *shape, cfg.vid_in_channels, generator=gen,
                          device=dev).to(torch.bfloat16)
        for plan_name, uniform in (("uniform", True), ("grouped", False)):
            dplan = nadit.upload_plan(nadit.build_dit_plan(
                cfg, shape, TXT_LEN, uniform=uniform), cfg, dev)

            def forward():
                with torch.no_grad():
                    return nadit.nadit_forward(model, vid, txt, t, dplan)

            forward()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            forward()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                forward()
            e.record()
            torch.cuda.synchronize()
            print(f"DiT forward {label} {shape} {plan_name} plan: "
                  f"{a.elapsed_time(e) / 5:.2f} ms, peak {peak:.3f} GiB above"
                  f" the resident {base / 2 ** 30:.3f} GiB", flush=True)


if __name__ == "__main__":
    main()
