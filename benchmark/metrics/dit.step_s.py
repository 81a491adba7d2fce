"""dit.step_s (s, the program's span): the pipeline's `dit` phase seconds
(ctx["timings"], ended by a device synchronise), the mean per request of
the traced window."""

from benchmark import stats


def read(run):
    return stats.mean_phase(run, "dit")
