"""device.mfu (%, counted work over the window): each request's counted
operations over the peak of their type (bf16 989 TFLOP/s, int8 1979
TOP/s), summed over the traced window's requests, over its wall time."""

from benchmark import stats


def read(run):
    return stats.mfu(run)
