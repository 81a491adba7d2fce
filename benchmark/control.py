"""Readings of the comparison that decides `correct`, over many seeds, for
setting a cell's limits: the program as the configuration states it
("program"), and the control ("control", the configuration's
`control_lane`): the program with its own path in the next precision down
switched on, or, where the program has none, the reference computed in
that precision in the program's place. Each seed serves the first `check_requests` inputs of its
pool once at the cell's own size and holds them to the reference, as a
run's check does. The benchmark's runs never run this.

    python3 -m benchmark.control --workload <cell> --lane program|control \\
        --seeds 1,2,3 [--out FILE]

prints one JSON line per seed: the seed, the lane, the worst readings and
whether the cell's limits (where it has them) pass them.
"""

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import compare, harness, program, traffic
from benchmark.reference import pipeline as ref_pipeline


def _reference_outputs(cell, seed, pool, k, quant, device):
    """The reference's outputs of the pool's first k inputs in the lane
    `quant`: the control where the program has no path of its own in the
    precision below the configuration's."""
    dit_state, vae_state = program.draw_weights(cell.cfg, seed, device)
    with torch.no_grad(), ref_pipeline.no_tf32():
        return [ref_pipeline.request(cell.cfg, cell.mix, dit_state,
                                     vae_state, pool.frames[i], pool.noise[i],
                                     pool.txt["pos"], quant).cpu().numpy()
                for i in range(k)]


def readings(cell: harness.Cell, seed: int, lane: str, device) -> dict:
    """The worst readings of one seed: the program as configured
    ("program") or the control ("control": the configuration's
    `control_lane`, the program's own lane one precision down, or with
    `reference_quant` the reference in that precision in its place)."""
    ctl = cell.cfg["control_lane"] if lane == "control" else {}
    t0 = time.perf_counter()
    pool = traffic.Pool(cell.mix, cell.cfg["vae"],
                        cell.cfg["dit"]["txt_in_dim"], seed, device)
    k = min(cell.mix["check_requests"], len(pool))
    if "reference_quant" in ctl:
        outs = _reference_outputs(cell, seed, pool, k, ctl["reference_quant"],
                                  device)
    else:
        runner = program.build(cell.cfg, seed, device, {
            k_: v for k_, v in ctl.items() if k_ != "why"})
        outs = [program.serve(runner, pool, i, cell.cfg, seed)[0]
                for i in range(k)]
        del runner
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t_prog = time.perf_counter() - t0
    got = harness.check(cell, seed, pool, list(range(k)), outs, device)
    correct, _ = compare.judge(got, cell.limits)
    return {"seed": seed, "lane": lane, "readings": got,
            "correct": correct if cell.limits else None,
            "program_s": t_prog, "reference_s": time.perf_counter() - t0
            - t_prog}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--lane", choices=("program", "control"), required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        line = json.dumps(readings(cell, int(s), args.lane, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
