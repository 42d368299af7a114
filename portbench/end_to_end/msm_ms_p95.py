"""The 95th percentile of the milliseconds each MSM of the window took, from
its call to the end of its device work (host clock, after a synchronize),
over every MSM of the window."""

import statistics


def read(run):
    if run.noun != "MSM" or len(run.durations) < 2:
        return None
    return statistics.quantiles(run.durations, n=20)[18] * 1e3
