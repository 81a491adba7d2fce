"""A/B of the two output routes of K6 / K7 (`csrc/quant_matmul.cu`) on one
GPU, at the q8 lane's record shape (K6, M=8160 N=7680 K=2560) and the q4
lane's (K7, M=16320 N=6912 K=2560).

    python -m seedvr2_tpu_torch.ab_qmm_epilogue [--iters 20]

The kernels write their output through TMA stores where its rows are
16-byte multiples (N % 8 == 0) and with the threads' own stores where they
are not, so N - 2 takes the second route at the same work within 0.03 %.
Turns A B B A (A: N, TMA stores; B: N - 2, the threads' stores), each the
mean of `--iters` calls timed alone with CUDA events after a 256 MB write
that evicts the L2. Prints the card's name and power limit, every turn,
and the mean of each route. Needs a CUDA device.
"""

import argparse
import subprocess

import torch

from .ops import quant_matmul as qm

SHAPES = (("K6 image 1080 qkv", 8160, 7680, 2560),
          ("K7 clip 1080 gate/up", 16320, 6912, 2560))


def _ms(fn, iters: int, flush: torch.Tensor) -> float:
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


def _call(name: str, m: int, n: int, k: int, gen: torch.Generator):
    """A closure launching K6 or K7 on random operands of (m, n, k)."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    if name.startswith("K6"):
        q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(n, k // 32, generator=gen, device="cuda") * 1e-3
        return lambda: qm.quant_matmul_q8(x, q, s)
    q = torch.randint(0, 16, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(n, k // 32, generator=gen, device="cuda") * 1e-3
    mn = torch.rand(n, k // 32, generator=gen, device="cuda") * 1e-2
    return lambda: qm.quant_matmul_affine(x, q, s, mn)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_qmm_epilogue: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    for name, m, n, k in SHAPES:
        routes = {"TMA stores": _call(name, m, n, k, gen),
                  "threads' stores": _call(name, m, n - 2, k, gen)}
        times = {r: [] for r in routes}
        for r in ("TMA stores", "threads' stores", "threads' stores",
                  "TMA stores"):
            ms = _ms(routes[r], args.iters, flush)
            times[r].append(ms)
            print(f"{name} M={m} K={k} {r} (N={n if r[0] == 'T' else n - 2})"
                  f": {ms:.4f} ms", flush=True)
        print(f"{name}: mean " + ", ".join(
            f"{r} {sum(v) / len(v):.4f} ms" for r, v in times.items()),
            flush=True)


if __name__ == "__main__":
    main()
