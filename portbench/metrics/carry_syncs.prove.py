"""Host syncs a proof in `mont.carry`'s test for a carry left
(`bool(hi.any())`, `ff/mont.py`): the program's counter
`sync.mont.carry`, over the proofs."""

from portbench import spans

NEEDS = ()


def read(run):
    rec = spans.latest()
    if rec is None or not run.jobs:
        return None
    n = rec.counters.get("sync.mont.carry")
    if n is None:
        return None
    return n / run.jobs
