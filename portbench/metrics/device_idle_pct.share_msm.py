"""The share of the traced window in which the device ran nothing, from
the profiler's trace."""

NEEDS = ()


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
