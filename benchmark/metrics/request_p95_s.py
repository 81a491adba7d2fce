"""request_p95_s (s, host clock): the nearest-rank 95th percentile of every
request time of the window."""

from benchmark import stats


def read(run):
    return stats.nearest_rank([r["wall_s"] for r in run.requests], 95)
