"""K4's share of its roofline: the least time of the folds it was given in
the window (each launch's lanes and steps, the entries that needed an add,
`work.k4_work`; the adds counted before the window, `hooks.k4_window`),
over K4's device time (kernel `msm_fold_kernel`)."""

from portbench import work

NEEDS = ("k4_launches",)
KERNEL = "msm_fold_kernel"


def read(run):
    if run.trace is None or not run.counters.k4:
        return None
    busy = run.trace.kernel_seconds(KERNEL)
    if not busy:
        return None
    least = sum(work.least_seconds(*work.k4_work(
        int(adds), lanes, steps, proj, words))
        for words, proj, lanes, steps, adds in run.counters.k4)
    return 100.0 * least / busy
