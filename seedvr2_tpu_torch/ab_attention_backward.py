"""Times the dq and dk/dv parts of K1's backward (`attention_backward_dq`,
`attention_backward_dkdv`) at the record shape (B=12 S=512 kv_len=463), at
the 1080p clip plan's largest window group (n = 32), at two shapes with the
record shape's rows but 2 and 4 times its keys a row (B=6 S=1024, B=3
S=2048: the same blocks, each walking 15 / 29 tiles where the record
shape's walk 8, so a cost a block shows beside a cost a tile) and at each
window group of the training plan (the 3B at a 1 x 64 x 64 latent, batch
2), with the sum over one train step's launches, and torch SDPA's
backward at the record shape as the yardstick, on one GPU.

    python seedvr2_tpu_torch/ab_attention_backward.py [--root DIR]
        [--iters 20]

`--root` names the checkout whose `seedvr2_tpu_torch` is imported (default:
the one this file lies in), so one command can time two trees in turns,
each in its own process (parent, change, change, parent). A tree whose dq
part forms the rows' lse itself (no `lse` argument) is timed through that
interface. Operands are drawn from seeds on the card (bf16 qkv with its
lane pad rows zero, random rope tables, an incoming gradient), q-hat and
k-hat from K1's own pre-pass. Each part: its kernel's device time from a
torch.profiler trace of `--iters` calls, each after a 256 MB write that
evicts the L2 (so host stalls between launches do not count), and but for
the training plan's groups also CUDA events around each call, the mean of
`--iters`. Prints the card's name and power limit, the tree, then one line
a measurement. Needs a CUDA device.
"""

import argparse
import inspect
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TXT_LEN = 58
TRAIN_LATENT, TRAIN_BATCH = (1, 64, 64), 2


def _event_ms(torch, fn, iters: int, flush) -> float:
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


def _device_ms(torch, fn, iters: int, flush, only: str) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and only in e.name)
    return us / iters / 1e3


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(HERE))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [d for d in sys.path if os.path.abspath(d or ".")
                            != HERE]
    import torch
    import torch.nn.functional as F

    from seedvr2_tpu_torch.core.configs import DIT_3B
    from seedvr2_tpu_torch.models.dit import nadit
    from seedvr2_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("ab_attention_backward: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"tree {root}", flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    H, D = DIT_3B.heads, DIT_3B.head_dim
    with_lse = "lse" in inspect.signature(
        fa.attention_backward_dq).parameters

    def parts(b, s, kv):
        """The two parts' calls on one shape's operands."""
        qkv = torch.randn(b, s, 3 * H * D, generator=gen, device=dev).to(
            torch.bfloat16)
        qkv[:, kv:] = 0
        ang = torch.randn(s, D // 2, generator=gen, device=dev)
        tabs = (torch.cos(ang).repeat_interleave(2, -1).contiguous(),
                torch.sin(ang).repeat_interleave(2, -1).contiguous()) * 2
        x = qkv.view(b, s, 3, H, D)
        qh, kh = fa.attention_prepass(x[:, :, 0], x[:, :, 1], *tabs, 1e-5,
                                      D ** -0.5 * 1.4426950408889634)
        dout = torch.randn(b, s, H * D, generator=gen, device=dev).to(
            torch.bfloat16)
        v = x[:, :, 2]
        if with_lse:
            out, lse = fa.packed_window_attention_lse(qkv, H, D, *tabs, 1e-5,
                                                      kv)
            dq = lambda: fa.attention_backward_dq(  # noqa: E731
                qh, kh, v, out, dout, lse, kv)
            _, delta = dq()
        else:
            out = fa.packed_window_attention(qkv, H, D, *tabs, 1e-5, kv)
            dq = lambda: fa.attention_backward_dq(  # noqa: E731
                qh, kh, v, out, dout, kv)
            _, lse, delta = dq()
        dkdv = lambda: fa.attention_backward_dkdv(  # noqa: E731
            qh, kh, v, dout, lse, delta, kv)
        calls = {"dq": (dq, "attn_bwd_dq"), "dk/dv": (dkdv, "attn_bwd_dkdv")}
        return calls, (qh, kh, v, dout)

    for label, b, s, kv in (("record B=12 S=512 kv_len=463", 12, 512, 463),
                            ("1080p clip plan largest group n=32 S=512 "
                             "kv_len=463", 32, 512, 463),
                            ("B=6 S=1024 kv_len=926", 6, 1024, 926),
                            ("B=3 S=2048 kv_len=1852", 3, 2048, 1852)):
        calls, (qh, kh, v, dout) = parts(b, s, kv)
        flops = b * H * kv * kv * D
        for name, (fn, only) in calls.items():
            dev_ms = _device_ms(torch, fn, args.iters, flush, only)
            ev_ms = _event_ms(torch, fn, args.iters, flush)
            n_ops = (6 if name == "dq" else 8) * flops
            print(f"{name} {label}: {dev_ms:.4f} ms device "
                  f"({n_ops / dev_ms / 1e9:.1f} TFLOP/s), {ev_ms:.4f} ms "
                  "events", flush=True)
        if b == 12:
            q, k, vv = (t.transpose(1, 2).detach().requires_grad_()
                        for t in (qh, kh, v))
            mask = (torch.arange(s, device=dev) < kv)[None, None, None, :]
            o = F.scaled_dot_product_attention(q, k, vv, attn_mask=mask)
            do = dout.view(b, s, H, D).transpose(1, 2)
            ms = _event_ms(torch, lambda: torch.autograd.grad(
                o, (q, k, vv), do, retain_graph=True), args.iters, flush)
            print(f"SDPA backward (dq, dk, dv at once) {label}: {ms:.4f} ms "
                  "events", flush=True)
            del q, k, vv, o
        del calls, qh, kh, v, dout

    plan = nadit.build_dit_plan(DIT_3B, TRAIN_LATENT, TXT_LEN)
    layers = DIT_3B.num_layers // len(plan.layer_plans)
    step = {"dq": 0.0, "dk/dv": 0.0}
    for method, lp in plan.layer_plans.items():
        for i, g in enumerate(lp.groups):
            n, wlen = g.idx.shape
            kv = wlen + TXT_LEN
            s = kv + (-kv) % 128
            calls, _ = parts(TRAIN_BATCH * n, s, kv)
            times = {name: _device_ms(torch, fn, args.iters, flush, only)
                     for name, (fn, only) in calls.items()}
            for name, ms in times.items():
                step[name] += layers * ms
            print(f"train plan {method} group {i} B={TRAIN_BATCH * n} S={s} "
                  f"kv_len={kv}: dq {times['dq']:.4f} ms, dk/dv "
                  f"{times['dk/dv']:.4f} ms device", flush=True)
            del calls
    print(f"one train step ({layers} launches of each group): dq "
          f"{step['dq']:.3f} ms, dk/dv {step['dk/dv']:.3f} ms, together "
          f"{sum(step.values()):.3f} ms device", flush=True)


if __name__ == "__main__":
    main()
