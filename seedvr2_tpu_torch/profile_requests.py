"""Time and profile full-width requests of the port on one GPU.

    [SEEDVR2_FUSED_NORM=1] python -m seedvr2_tpu_torch.profile_requests \\
        [--family dit_3b|dit_7b] [--preset throughput] \\
        [--quant q8|q4|q4k|w8a8] [--vae_quant int8] \\
        [--requests clip720,image1080] [--reps 3] [--trace DIR]

Builds the DiT of --family (the 3B by default, or the full-width 7B) +
VAE_V3 with random weights from a seed on the card (the
w8a8 DiT and tiled VAE with --preset throughput; --quant converts the DiT as
the CLI does, and wins over the preset; --vae_quant int8 serves the VAE
decoder's resnet convs in int8, and SEEDVR2_FUSED_NORM=1 turns on the fused
norm pass, as in the CLI), then for each request:
one warm-up, `--reps` timed repetitions (request wall seconds and the
request record: the pipeline's spans in host seconds, each phase ended by
a device synchronize, and its copy counters in bytes; utils/spans.py), and
one repetition under torch.profiler (CPU + CUDA). From the profile it
prints the profiled wall time, the spans the request opened, the device
events that took the most time (as shares of the summed device time, which
counts overlapping streams twice: the benchmark's traced run gives the
device's busy union), the device time of the port's named ranges (the
phases seedvr2.encode / dit / decode / postprocess, their steps, and
norm_silu_quantize: the int8 lane's norm + SiLU + quantize passes), and
for each phase the device events that took the most of its time. With
--trace it also sums the bytes of the trace's host-device copies (Memcpy
HtoD / DtoH) beside the record's h2d_bytes / d2h_bytes. First it prints
what one span costs on the host, without the profiler and under it. Needs
a CUDA device.
"""

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from . import cli
from .core.configs import dit_config_for
from .utils import spans
from .utils.text_embeds import load_text_embeddings

# name -> (frames, height, width, target short side)
REQUESTS = {
    "image720": (1, 360, 640, 720),
    "clip720": (5, 360, 640, 720),
    "image1080": (1, 540, 960, 1080),
    "clip1080": (5, 540, 960, 1080),
    "image2160": (1, 1080, 1920, 2160),
}


def make_frames(t: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour gradients plus noise in [0, 1], (t, h, w, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    base = np.stack([yy, xx, 1 - 0.5 * (yy + xx)], -1)[None]
    frames = base + 0.05 * rng.standard_normal((t, h, w, 3))
    return np.clip(frames, 0, 1).astype(np.float32)


def _device_us(evt) -> float:
    """Device microseconds of a device-side event (kernel, copy, memset);
    0 for host-side events, whose device time is their kernels', and for
    the device-side span of a named range, which would count its kernels
    twice."""
    if (getattr(evt, "device_type", None) != DeviceType.CUDA
            or evt.key.startswith(spans.PREFIX)):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def span_cost_us(n: int = 20000) -> float:
    """Host microseconds of one span's enter and exit inside a record."""
    with spans.recording({}):
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6


def memcpy_bytes(trace_path: str) -> dict:
    """{"HtoD" / "DtoH": [copies, bytes]} of a chrome trace's host-device
    copies (the device's `Memcpy HtoD (...)` / `Memcpy DtoH (...)`
    events and their `bytes`)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {"HtoD": [0, 0], "DtoH": [0, 0]}
    for e in events:
        name = e.get("name", "")
        if not name.startswith("Memcpy "):
            continue
        for kind in out:
            if kind in name:
                out[kind][0] += 1
                out[kind][1] += int(e.get("args", {}).get("bytes", 0))
    return out


PHASES = ("encode", "dit", "decode", "postprocess")
PHASE_TOP = 15  # device events listed for each phase


def phase_breakdown(events, device_us=_device_us):
    """{phase: {event name: device us}} over the device events that start
    inside a phase's range. `events` is the profile's event list
    (`prof.events()`); the pipeline's phase ranges end after a device
    synchronise and the phases run one after another, so a phase's kernels
    start and end inside its range on the profile's common clock."""
    ranges = [(e.key[len(spans.PREFIX):], e.time_range.start,
               e.time_range.end) for e in events
              if e.key.startswith(spans.PREFIX)
              and getattr(e, "device_type", None) != DeviceType.CUDA
              and e.key[len(spans.PREFIX):] in PHASES]
    out = {name: {} for name, _, _ in ranges}
    for e in events:
        us = device_us(e)
        if us <= 0:
            continue
        for name, a, b in ranges:
            if a <= e.time_range.start <= b:
                out[name][e.key] = out[name].get(e.key, 0.0) + us
                break
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", default="dit_3b", choices=("dit_3b", "dit_7b"))
    p.add_argument("--preset", default=None, choices=("throughput",))
    p.add_argument("--quant", default=None, choices=cli.QUANT_MODES)
    p.add_argument("--vae_quant", default="none", choices=("none", "int8"))
    p.add_argument("--requests", default="clip720",
                   help="comma-separated names of " + ", ".join(REQUESTS))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None,
                   help="directory for chrome traces of the profiled runs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_requests needs a CUDA device")
    names = args.requests.split(",")
    for n in names:
        if n not in REQUESTS:
            raise ValueError(f"unknown request {n!r}; known: {list(REQUESTS)}")
    device = torch.device("cuda", 0)
    flags = (["unused.npy"]
             + (["--preset", args.preset] if args.preset else [])
             + (["--quant", args.quant] if args.quant else []))
    cargs = cli.parse_arguments(flags)
    tiling = cli.tiling_from_args(cargs)
    runner = cli.make_runner(device, seed=args.seed, quant=cargs.quant,
                             tiling=tiling, vae_quant=args.vae_quant,
                             dit_cfg=dit_config_for(args.family))
    embeds = load_text_embeddings(txt_dim=runner.dit_cfg.txt_in_dim)
    print(f"device {torch.cuda.get_device_name(0)}; {args.family}; "
          f"quant {cargs.quant}; "
          f"vae_quant {args.vae_quant}; {runner.vae.lowering}; {tiling}",
          flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    span_cost_us(2000)  # warm-up
    bare = span_cost_us()
    with torch.profiler.profile(activities=acts):
        traced = span_cost_us()
    print(f"one span: {bare:.2f} us on the host, {traced:.2f} us under "
          "torch.profiler", flush=True)

    for i, name in enumerate(names):
        t, h, w, res = REQUESTS[name]
        frames = make_frames(t, h, w, seed=10 + i)

        def once():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, timings = cli.process_frames(runner, frames, embeds,
                                            resolution=res, seed=42)
            return time.perf_counter() - t0, timings

        once()  # warm-up
        torch.cuda.reset_peak_memory_stats(device)
        for r in range(args.reps):
            wall, timings = once()
            print(f"{name} rep {r}: wall {wall:.3f} s; "
                  + spans.format_record(timings), flush=True)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        with torch.profiler.profile(activities=acts) as prof:
            wall, timings = once()
        events = prof.key_averages()
        summed = sum(_device_us(e) for e in events) / 1e6
        opened = sum(e.count for e in events
                     if e.key.startswith(spans.PREFIX)
                     and getattr(e, "device_type", None) != DeviceType.CUDA)
        print(f"{name} profiled: wall {wall:.3f} s, {opened} spans opened, "
              f"peak device memory {peak:.2f} GiB; "
              + spans.format_record(timings), flush=True)
        top = sorted(events, key=_device_us, reverse=True)[:args.top]
        for e in top:
            us = _device_us(e)
            if us <= 0:
                break
            print(f"  {us / 1e3:10.2f} ms {100 * us / 1e6 / summed:5.1f} % "
                  f"x{e.count:<6d} {e.key[:110]}", flush=True)
        for e in events:  # the port's named ranges: their kernels' time
            if (e.key.startswith(spans.PREFIX)
                    and getattr(e, "device_type", None) != DeviceType.CUDA):
                us = float(getattr(e, "device_time_total", 0.0))
                print(f"  range {e.key}: {us / 1e3:.2f} ms of device time "
                      f"({100 * us / 1e6 / summed:.1f} %), x{e.count}",
                      flush=True)
        for phase, by_name in phase_breakdown(prof.events()).items():
            total = sum(by_name.values())
            print(f"  phase {phase}: {total / 1e3:.2f} ms of device time in "
                  f"{len(by_name)} distinct events; the most:", flush=True)
            for key, us in sorted(by_name.items(), key=lambda kv: -kv[1])[
                    :PHASE_TOP]:
                print(f"    {us / 1e3:10.2f} ms {100 * us / total:5.1f} % "
                      f"{key[:110]}", flush=True)
        if args.trace:
            path = (f"{args.trace}/{name}_{args.family}_"
                    f"{args.preset or 'default'}_{cargs.quant}_"
                    f"{args.vae_quant}.json")
            prof.export_chrome_trace(path)
            copies = memcpy_bytes(path)
            for kind, key in (("HtoD", spans.H2D), ("DtoH", spans.D2H)):
                n, nbytes = copies[kind]
                counted = timings.get(key, 0)
                print(f"  trace Memcpy {kind}: {n} copies, {nbytes} B; "
                      f"{key} {counted} B "
                      f"({100 * (counted - nbytes) / max(nbytes, 1):+.3f} %)",
                      flush=True)


if __name__ == "__main__":
    main()
