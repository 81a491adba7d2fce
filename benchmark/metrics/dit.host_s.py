"""dit.host_s (s, the program's span): the pipeline's `dit.host`, the DiT
phase's host seconds up to its closing device synchronise (ctx["timings"]),
the mean per request of the traced window. The DiT path has no other host
synchronise, so beside `dit.step_s` it says how far the host's enqueueing
sets the DiT's pace. None where the program records no such span."""

from benchmark import stats


def read(run):
    return stats.mean_phase(run, "dit.host")
