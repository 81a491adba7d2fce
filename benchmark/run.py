"""Run one cell of the benchmark once, on the machine it is started on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up builds the cell's runner through the
port's CLI with weights drawn from the seed, makes the pool of inputs and
serves one warm-up request; the window then serves requests back to back
for --seconds (one client, closed loop), under torch.profiler with
--trace 1. The last line of standard output is the result (JSON): the
cell's end-to-end metrics (--trace 0) or its per-layer metrics (--trace 1),
the device, and each number that decides `correct` beside its limit, which
the last lines of standard error repeat. Exits 3 without a result when no
CUDA device (or too few) is visible, 4 when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded JAX or the JAX package: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
