"""post.host_s (s, the program's spans): the postprocess phase's host-only
steps, `postprocess.prepare` (the reference batch's padding) +
`postprocess.write` (the writes into the output, the overlay, the trim),
each the mean per request of the traced window. None where the program
records neither."""

from benchmark import stats

KEYS = ("postprocess.prepare", "postprocess.write")


def read(run):
    means = [v for v in (stats.mean_phase(run, k) for k in KEYS)
             if v is not None]
    return sum(means) if means else None
