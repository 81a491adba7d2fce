"""io.d2h_mib (MiB, the program's counter): `d2h_bytes`, the bytes the
request copied from device tensors into host arrays (ctx["timings"]), the
mean per request of the traced window, in MiB. None where the program
counts none."""

from benchmark import stats


def read(run):
    v = stats.mean_phase(run, "d2h_bytes")
    return None if v is None else v / 2 ** 20
