"""vae.decode_host_s (s, the program's spans): the decode phase's host-only
steps, `decode.alloc` (the output buffer) + `decode.write` (overlap blend
and write into it) + `decode.vae.plan` (a tiled decode's plan, fades and
count), each the mean per request of the traced window. None where the
program records none of them."""

from benchmark import stats

KEYS = ("decode.alloc", "decode.write", "decode.vae.plan")


def read(run):
    means = [v for v in (stats.mean_phase(run, k) for k in KEYS)
             if v is not None]
    return sum(means) if means else None
