"""device.idle_share (%, device trace): 1 - the union of the intervals in
which a kernel, copy or memset ran over the traced window's wall time."""


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
