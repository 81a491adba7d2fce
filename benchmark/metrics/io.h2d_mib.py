"""io.h2d_mib (MiB, the program's counter): `h2d_bytes`, the bytes the
request copied from host arrays into tensors (ctx["timings"]), the mean per
request of the traced window, in MiB. None where the program counts none."""

from benchmark import stats


def read(run):
    v = stats.mean_phase(run, "h2d_bytes")
    return None if v is None else v / 2 ** 20
