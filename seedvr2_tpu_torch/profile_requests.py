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
pipeline's phase seconds, host clock, each phase ended by a device
synchronize), and one repetition under torch.profiler (CPU + CUDA). From
the profile it prints the device busy time (the summed device time of the
device-side events: kernels, copies and memsets, all on one stream), the
profiled wall time, the device events that took the most time, the
device time of the port's named ranges (the pipeline's phases
seedvr2.encode / dit / decode / postprocess, and seedvr2.norm_silu_quantize:
the int8 lane's norm + SiLU + quantize passes), and for each phase the
device events that took the most of its time. Needs a CUDA device.
"""

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from . import cli
from .core.configs import dit_config_for
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


RANGE_PREFIX = "seedvr2."  # the port's named profiler ranges


def _device_us(evt) -> float:
    """Device microseconds of a device-side event (kernel, copy, memset);
    0 for host-side events, whose device time is their kernels', and for
    the device-side span of a named range, which would count its kernels
    twice."""
    if (getattr(evt, "device_type", None) != DeviceType.CUDA
            or evt.key.startswith(RANGE_PREFIX)):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


PHASES = ("encode", "dit", "decode", "postprocess")
PHASE_TOP = 15  # device events listed for each phase


def phase_breakdown(events, device_us=_device_us):
    """{phase: {event name: device us}} over the device events that start
    inside a phase's range. `events` is the profile's event list
    (`prof.events()`); the pipeline's phase ranges end after a device
    synchronise and the phases run one after another, so a phase's kernels
    start and end inside its range on the profile's common clock."""
    spans = [(e.key[len(RANGE_PREFIX):], e.time_range.start,
              e.time_range.end) for e in events
             if e.key.startswith(RANGE_PREFIX)
             and getattr(e, "device_type", None) != DeviceType.CUDA
             and e.key[len(RANGE_PREFIX):] in PHASES]
    out = {name: {} for name, _, _ in spans}
    for e in events:
        us = device_us(e)
        if us <= 0:
            continue
        for name, a, b in spans:
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
            print(f"{name} rep {r}: wall {wall:.3f} s; " + ", ".join(
                f"{k} {v:.4f} s" for k, v in timings.items()), flush=True)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall, timings = once()
        events = prof.key_averages()
        busy = sum(_device_us(e) for e in events) / 1e6
        print(f"{name} profiled: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"(idle <= {100 * (1 - busy / wall):.0f} %), peak device "
              f"memory {peak:.2f} GiB", flush=True)
        top = sorted(events, key=_device_us, reverse=True)[:args.top]
        for e in top:
            us = _device_us(e)
            if us <= 0:
                break
            print(f"  {us / 1e3:10.2f} ms {100 * us / 1e6 / busy:5.1f} % "
                  f"x{e.count:<6d} {e.key[:110]}", flush=True)
        for e in events:  # the port's named ranges: their kernels' time
            if (e.key.startswith(RANGE_PREFIX)
                    and getattr(e, "device_type", None) != DeviceType.CUDA):
                us = float(getattr(e, "device_time_total", 0.0))
                print(f"  range {e.key}: {us / 1e3:.2f} ms of device time "
                      f"({100 * us / 1e6 / busy:.1f} %), x{e.count}",
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
            prof.export_chrome_trace(f"{args.trace}/{name}_{args.family}_"
                                     f"{args.preset or 'default'}_"
                                     f"{cargs.quant}_{args.vae_quant}.json")


if __name__ == "__main__":
    main()
