"""K1's share of its roofline: the least time of the Montgomery products of
every K1 launch in the window (exact sizes, `work.k1_work`), over K1's
device time (kernel `mont_mul_kernel`)."""

from portbench import work

NEEDS = ("k1_launches",)
KERNEL = "mont_mul_kernel"


def read(run):
    if run.trace is None or not run.counters.k1:
        return None
    busy = run.trace.kernel_seconds(KERNEL)
    if not busy:
        return None
    least = sum(work.least_seconds(*work.k1_work(n, words))
                for words, n in run.counters.k1)
    return 100.0 * least / busy
