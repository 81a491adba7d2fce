"""Observability: categorised logging, hierarchical timers, memory stats.

Port of seedvr2_tpu.utils.debug with the same methods and log text: wall
phase timers with parent / child breakdowns, device memory from
torch.cuda (allocated, peak, reserved, the card's total), host RAM and
process RSS (psutil where it is importable, else /proc), a torch.profiler
chrome trace per phase when a profile directory is given, and a summary.
"""

import contextlib
import os
import time
from typing import Dict, List, Optional

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

_GB = 1024 ** 3


def _rank_tag() -> str:
    """' [rankN]' when a torch.distributed process group of more than one
    rank is initialised (the port's multi-process serving: torchrun, the
    CLI's launcher, --num_hosts fleets), '' otherwise; as the JAX package
    tags its multi-process runs (the reference's rank-tagged logging)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return f" [rank{dist.get_rank()}]"
    return ""


def _host_memory() -> Dict[str, float]:
    """RAM used / total and this process's RSS in GiB: psutil, or /proc
    where psutil is missing."""
    if psutil is not None:
        vm = psutil.virtual_memory()
        return {"ram_used_gb": (vm.total - vm.available) / _GB,
                "ram_total_gb": vm.total / _GB,
                "rss_gb": psutil.Process().memory_info().rss / _GB}
    stats: Dict[str, float] = {}
    try:
        with open("/proc/meminfo") as f:
            info = {line.split(":")[0]: int(line.split()[1]) * 1024
                    for line in f if line.split()[0].rstrip(":")
                    in ("MemTotal", "MemAvailable")}
        stats["ram_used_gb"] = (info["MemTotal"] - info["MemAvailable"]) / _GB
        stats["ram_total_gb"] = info["MemTotal"] / _GB
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        stats["rss_gb"] = rss_pages * os.sysconf("SC_PAGE_SIZE") / _GB
    except (OSError, KeyError, ValueError, IndexError):
        pass
    return stats


class Debug:
    def __init__(self, enabled: bool = False, profile_dir: Optional[str] = None):
        self.enabled = enabled
        self.profile_dir = profile_dir
        self._timers: Dict[str, float] = {}
        self._elapsed: Dict[str, float] = {}
        self._stack: List[str] = []
        self._children: Dict[str, List[str]] = {}
        self._checkpoints: List = []
        # chrome traces written by profile(), in order
        self.traces: List[str] = []

    # ------------------------------------------------------------- logging

    def log(self, message: str, category: str = "info", level: str = "INFO",
            force: bool = False, indent_level: int = 0):
        if not (self.enabled or force):
            return
        indent = "  " * indent_level
        ts = time.strftime("%H:%M:%S")
        print(f"[{ts}]{_rank_tag()} [{category}] {indent}{message}",
              flush=True)

    # -------------------------------------------------------------- timers

    def start_timer(self, name: str):
        self._timers[name] = time.perf_counter()
        if self._stack:
            self._children.setdefault(self._stack[-1], []).append(name)
        self._stack.append(name)

    def end_timer(self, name: str, message: str = "",
                  show_breakdown: bool = False) -> float:
        start = self._timers.pop(name, None)
        if name in self._stack:
            self._stack = self._stack[: self._stack.index(name)]
        if start is None:
            return 0.0
        elapsed = time.perf_counter() - start
        self._elapsed[name] = elapsed
        if message:
            self.log(f"{message}: {elapsed:.2f}s", category="timer")
        if show_breakdown:
            for child in self._children.get(name, []):
                if child in self._elapsed:
                    self.log(f"  {child}: {self._elapsed[child]:.2f}s",
                             category="timer", indent_level=1)
        return elapsed

    def elapsed(self, name: str) -> float:
        return self._elapsed.get(name, 0.0)

    @contextlib.contextmanager
    def timer(self, name: str, message: str = ""):
        self.start_timer(name)
        try:
            yield
        finally:
            self.end_timer(name, message or name)

    @contextlib.contextmanager
    def profile(self, name: str):
        """A torch.profiler trace around a phase, written as a chrome trace
        into profile_dir/name (one file a call, numbered in order); nothing
        without a profile_dir. The profiler is freed before the call
        returns, so it holds no buffers into the next phase."""
        if not self.profile_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        out_dir = os.path.join(self.profile_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=activities)
        with prof:
            yield
        path = os.path.join(out_dir, f"trace_{len(self.traces):04d}.json")
        prof.export_chrome_trace(path)
        del prof
        self.traces.append(path)

    # -------------------------------------------------------------- memory

    def memory_state(self) -> Dict[str, float]:
        """Device memory of the current CUDA device (allocated, its peak,
        reserved, the card's total as the limit) under the JAX package's
        hbm_* keys when a GPU is visible, then host RAM and RSS."""
        stats: Dict[str, float] = {}
        import torch

        if torch.cuda.is_available():
            _free, total = torch.cuda.mem_get_info()
            stats["hbm_used_gb"] = torch.cuda.memory_allocated() / _GB
            stats["hbm_limit_gb"] = total / _GB
            stats["hbm_peak_gb"] = torch.cuda.max_memory_allocated() / _GB
            stats["hbm_reserved_gb"] = torch.cuda.memory_reserved() / _GB
        # Process RSS is the observable behind the streaming CLI's
        # bounded-memory claim (--chunk_size): per-chunk checkpoints must
        # show a flat RSS profile (reference tracks it via psutil in
        # memory_manager.py:166-208).
        stats.update(_host_memory())
        return stats

    def log_memory_state(self, label: str, **_kwargs):
        if not self.enabled:
            return
        s = self.memory_state()
        parts = []
        if "hbm_used_gb" in s:
            parts.append(f"HBM {s['hbm_used_gb']:.2f}/{s.get('hbm_limit_gb', 0):.2f}GB"
                         f" (peak {s.get('hbm_peak_gb', 0):.2f}GB)")
        if "ram_used_gb" in s:
            parts.append(f"RAM {s['ram_used_gb']:.1f}/{s['ram_total_gb']:.1f}GB")
        if "rss_gb" in s:
            parts.append(f"RSS {s['rss_gb']:.2f}GB")
        self.log(f"{label}: {', '.join(parts)}", category="memory")

    # ------------------------------------------ checkpoints / env / summary

    def checkpoint(self, label: str) -> Dict[str, float]:
        """Named memory checkpoint with deltas vs the previous checkpoint
        (reference debug.py:346-592 memory checkpoints/diffs)."""
        state = self.memory_state()
        prev = self._checkpoints[-1][1] if self._checkpoints else {}
        self._checkpoints.append((label, state))
        if self.enabled:
            deltas = []
            for key, short in (("hbm_used_gb", "HBM"), ("ram_used_gb", "RAM"),
                               ("rss_gb", "RSS")):
                if key in state and key in prev:
                    deltas.append(f"{short} {state[key] - prev[key]:+.2f}GB")
            extra = f" (delta {', '.join(deltas)})" if deltas else ""
            self.log_memory_state(f"checkpoint[{label}]")
            if extra:
                self.log(f"checkpoint[{label}]{extra}", category="memory")
        return state

    @property
    def checkpoints(self) -> List:
        """[(label, memory_state), ...] in the order they were taken."""
        return list(self._checkpoints)

    def log_environment(self):
        """Environment header (reference debug.py:153-214)."""
        if not self.enabled:
            return
        import platform

        import numpy as np
        import torch

        parts = [f"python {platform.python_version()}",
                 platform.platform(terse=True), f"torch {torch.__version__}",
                 f"cuda {torch.version.cuda}"]
        if torch.cuda.is_available():
            parts.append(f"backend cuda ({torch.cuda.device_count()}x "
                         f"{torch.cuda.get_device_name(0)})")
        else:
            parts.append("backend cpu (no CUDA device visible)")
        parts.append(f"numpy {np.__version__}")
        self.log(" | ".join(parts), category="env", force=True)

    def summary(self, swap_stats: Optional[Dict] = None):
        """End-of-job summary: peak memory + phase timer totals + swap
        telemetry (reference debug.py:594-736)."""
        if not self.enabled:
            return
        s = self.memory_state()
        if "hbm_peak_gb" in s and s["hbm_peak_gb"]:
            self.log(f"peak HBM {s['hbm_peak_gb']:.2f}GB "
                     f"of {s.get('hbm_limit_gb', 0):.2f}GB",
                     category="summary")
        phases = [(n, t) for n, t in self._elapsed.items()
                  if n.startswith("phase")]
        total = sum(t for _, t in phases)
        for name, t in phases:
            self.log(f"{name}: {t:.2f}s ({t / total:.0%})"
                     if total else f"{name}: {t:.2f}s", category="summary")
        if swap_stats and swap_stats.get("total_swaps"):
            self.log(
                f"blockswap: {swap_stats['block_swaps']} swaps, "
                f"stall avg {swap_stats.get('block_avg_ms', 0):.1f}ms, "
                f"one transfer {swap_stats.get('measured_transfer_ms', 0):.1f}ms",
                category="summary")
