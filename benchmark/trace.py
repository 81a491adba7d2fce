"""What the traced run reads from torch.profiler's trace of the window:
the device's busy time as the union of the intervals in which a kernel,
copy or memset ran (so overlapping streams count once), the device time of
each kernel by name, and the longest idle gaps with the host operation
that was running through each."""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

# named ranges (the program's `seedvr2.<phase>`, the benchmark's own): their
# device-side spans cover kernels that are counted on their own
RANGE_PREFIXES = ("seedvr2.", "benchmark.")


@dataclass
class Trace:
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _is_range(name: str) -> bool:
    return name.startswith(RANGE_PREFIXES)


def summarize(events, top: int = 10) -> Trace:
    """events: the profiler's raw events (`kineto_results.events()`: name,
    device type, start and end in ns on one clock), read once each; the
    window is the host span `benchmark.window`."""
    device, host = [], []
    kernel_s: Dict[str, float] = {}
    t0 = t1 = None
    for e in events:
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if b > a and not _is_range(name):
                device.append((a, b))
                kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-9
        else:
            if name == "benchmark.window":
                t0, t1 = a, b
            host.append((name, a, b))
    if t0 is None:
        raise ValueError("the trace holds no benchmark.window span")
    busy = merged([(max(a, t0), min(b, t1)) for a, b in device
                   if min(b, t1) > max(a, t0)])
    gaps, prev = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inner = phase = None
        for name, s, f in host:
            if not s <= mid <= f:
                continue
            if _is_range(name):
                if name.startswith("seedvr2.") and (
                        phase is None or f - s < phase[1]):
                    phase = (name, f - s)
            elif inner is None or f - s < inner[1]:
                inner = (name, f - s)
        label = "/".join(x[0] for x in (phase, inner) if x) or "host idle"
        named.append((label, (b - a) * 1e-9))
    return Trace(busy_s=sum(b - a for a, b in busy) * 1e-9,
                 kernel_s=kernel_s, gaps=named)


def top_ops(kernel_s: Dict[str, float], top: int = 10):
    """[[name, seconds]] of the device operations that took longest."""
    items = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], s] for name, s in items]
