"""The arithmetic the metric readers share."""

import math
import re
from typing import List, Optional

from .counts import peaks

# the profiler names of each hand-written kernel's launches on the main path
KERNEL_NAMES = {
    "k1": re.compile(r"(^|\W)(attention_kernel|qk_prepass_kernel)\b"),
    "k3": re.compile(r"(^|\W)s8_gemm_kernel\b"),
}


def nearest_rank(values: List[float], q: float) -> float:
    """The q-th percentile by nearest rank: the ceil(q/100 * n)-th smallest."""
    if not values:
        raise ValueError("no values")
    ranked = sorted(values)
    return ranked[max(1, math.ceil(q / 100.0 * len(ranked))) - 1]


def frames_per_s(run) -> float:
    """Every output frame of the window over the window's whole time, from
    its start to the end of its last request."""
    return sum(r["frames"] for r in run.requests) / run.window_s


def mean_phase(run, phase: str) -> Optional[float]:
    """The pipeline's seconds in one phase, the mean over the requests."""
    vals = [r["timings"][phase] for r in run.requests
            if phase in r["timings"]]
    return sum(vals) / len(vals) if vals else None


def roofline_share(run, kernel: str) -> Optional[float]:
    """The kernel's bound time over its device time in the trace, in %:
    the bound is the larger of the counted operations over the peak of
    their type and the counted bytes over the memory's, per request, times
    the requests of the window. None where the kernel did not run."""
    if run.trace is None:
        return None
    pat = KERNEL_NAMES[kernel]
    device_s = sum(s for name, s in run.trace.kernel_s.items()
                   if pat.search(name))
    bound = sum(peaks.bound_s(w.ops, w.bytes, w.dtype) for w in run.work
                if w.kernel == kernel) * len(run.requests)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s


def mfu(run) -> Optional[float]:
    """Every request's counted operations, each over the peak of its type,
    summed over the window's requests, over the window's wall time, in %."""
    if not run.work:
        return None
    per_request = sum(w.ops / peaks.PEAK_OPS[w.dtype] for w in run.work)
    return 100.0 * per_request * len(run.requests) / run.window_s
