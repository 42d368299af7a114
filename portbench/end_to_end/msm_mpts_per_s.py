"""Millions of points a second: the points of every correct MSM of the
window over all the window's seconds."""


def read(run):
    if run.noun != "MSM" or not run.n_ok:
        return None
    return run.n_ok * run.items_per_job / run.window_s / 1e6
