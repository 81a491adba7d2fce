"""kernels.k3_roofline (%, device trace): K3 (the w8a8 lane's s8 GEMM, by
kernel name) against its bound: the benchmark's count of its operations
and bytes over the H100's int8 and memory peaks, over K3's device time in
the trace."""

from benchmark import stats


def read(run):
    return stats.roofline_share(run, "k3")
