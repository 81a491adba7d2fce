"""One run of one cell: set-up, the measured window, the trace, the
metrics and the comparison that decides `correct`.

Everything a cell is made of is found by name: the cell's entry in
`BENCHMARK.json`, its configuration file, its traffic mix
(`workloads/<traffic>.json`), its limits (`limits/<cell>.json`) and one
reader per metric (`metrics/<metric>.py`, `read(run) -> float or None`).
"""

import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import compare, program, trace as trace_lib, traffic
from .counts import request as request_counts
from .reference import pipeline as ref_pipeline

HERE = Path(__file__).resolve().parent
BENCHMARK_JSON = HERE.parent / "BENCHMARK.json"
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "seedvr2_tpu")


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    limits: dict
    chips: int = 1
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, path: Path = BENCHMARK_JSON) -> Cell:
    with open(path) as f:
        bench = json.load(f)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(path.parent / conf["file"]) as f:
        cfg = json.load(f)
    return Cell(name=name, cfg=cfg, mix=traffic.load(entry["traffic"]),
                limits=compare.load_limits(name), chips=entry["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    requests: List[dict]          # wall_s, frames, timings, input
    window_s: float
    setup_s: float
    peak_bytes: int
    work: list                    # counts.work.Work of one request
    trace: Optional[trace_lib.Trace] = None


def read_metric(name: str, run: Run) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(runner, pool, cell: Cell, seed: int, seconds: float):
    """Requests back to back, cycling through the pool, until `seconds`
    have passed; the one in flight at the deadline finishes and counts."""
    requests, outputs = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with torch.profiler.record_function("benchmark.window"):
        while True:
            i = len(requests) % len(pool)
            a = time.perf_counter()
            with torch.profiler.record_function("benchmark.request"):
                out, timings = program.serve(runner, pool, i, cell.cfg, seed)
            b = time.perf_counter()
            requests.append({"wall_s": b - a, "frames": int(out.shape[0]),
                             "timings": timings, "input": i})
            outputs.append(out)
            if b >= deadline:
                break
    return requests, outputs, b - t0


def check(cell: Cell, seed: int, pool, inputs: List[int], outputs,
          device) -> Dict[str, float]:
    """The worst readings of `outputs` (the outputs of the pool's `inputs`)
    against the reference, run once per distinct input with TF32 off, on
    the weights drawn again from the seed."""
    dit_state, vae_state = program.draw_weights(cell.cfg, seed, device)
    refs, got = {}, []
    with torch.no_grad(), ref_pipeline.no_tf32():
        for i, out in zip(inputs, outputs):
            if i not in refs:
                refs[i] = ref_pipeline.request(
                    cell.cfg, cell.mix, dit_state, vae_state, pool.frames[i],
                    pool.noise[i], pool.txt["pos"], cell.cfg["lane"]["quant"])
            got.append(compare.readings(out, refs[i]))
    return compare.worst(got)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """One run; returns the result object (the last key, "check", holds
    each compared number beside its limit)."""
    runner = program.build(cell.cfg, seed, device)
    pool = traffic.Pool(cell.mix, cell.cfg["vae"],
                        cell.cfg["dit"]["txt_in_dim"], seed, device)
    program.serve(runner, pool, 0, cell.cfg, seed)  # warm-up of the shape
    _sync(device)
    setup_s = time.perf_counter() - t_start
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    requests, outputs, window_s = _window(runner, pool, cell, seed, seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr = None
    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        events = prof.profiler.kineto_results.events()
        t_exit = time.perf_counter() - t
        tr = trace_lib.summarize(events)
        print(f"trace: {len(events)} events, profiler stop "
              f"{t_exit:.1f} s, reading {time.perf_counter() - t - t_exit:.1f}"
              " s", file=sys.stderr)
        del prof, events
    run = Run(cell=cell, requests=requests, window_s=window_s,
              setup_s=setup_s, peak_bytes=peak,
              work=request_counts.request(cell.cfg, cell.mix), trace=tr)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    sample = traffic.check_sample(len(outputs), cell.mix["check_requests"],
                                  seed)
    got = check(cell, seed, pool, [requests[k]["input"] for k in sample],
                [outputs[k] for k in sample], device)
    correct, table = compare.judge(got, cell.limits)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if device.type == "cuda" else None}
    result = {"correct": correct, "attempted": len(requests), "failed": 0,
              "metrics": metrics, "device": dev,
              "readings": got, "checked_requests": sample,
              "reference_s": time.perf_counter() - t_ref}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": trace_lib.top_ops(tr.kernel_s),
                               "idle_gaps": [list(g) for g in tr.gaps]}
    result["check"] = table
    return result


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def check_lines(table: Dict[str, dict]) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            for k, v in table.items()]


def emit(result: dict) -> None:
    """The compared numbers as the last lines on standard error, the result
    as the last line of standard output."""
    lines = check_lines(result["check"]) or ["check: no limits for this cell"]
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
