"""kernels.k1_roofline (%, device trace): K1 (the windowed attention's
pre-pass and step, by kernel name) against its bound: the benchmark's
count of its operations and bytes over the H100's bf16 and memory peaks,
over K1's device time in the trace."""

from benchmark import stats


def read(run):
    return stats.roofline_share(run, "k1")
