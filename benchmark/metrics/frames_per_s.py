"""frames_per_s (frames/s, host clock): every output frame of the window
over the time from its start to the end of its last request."""

from benchmark import stats


def read(run):
    return stats.frames_per_s(run)
