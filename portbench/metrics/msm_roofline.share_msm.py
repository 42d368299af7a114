"""The MSM's share of its roofline: the least time of the MSMs of the
window, counted from their inputs alone (`work.msm_work`: N points of
254-bit scalars, the cheapest Pippenger), over the device's busy time in
the window."""

from portbench import work

NEEDS = ()


def read(run):
    if run.trace is None or not run.trace.busy_s or not run.jobs:
        return None
    ops, nbytes = work.msm_work(run.items_per_job)
    least = run.jobs * work.least_seconds(ops, nbytes)
    return 100.0 * least / run.trace.busy_s
