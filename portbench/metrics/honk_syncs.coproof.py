"""Host syncs a proof at the program's host-blocking sites: the sum of its
`sync.<site>` counters (`utils/timing.blocking`; the co-UltraHonk prover's
own under `sync.honk.*`), over the proofs."""

from portbench import spans

NEEDS = ()


def read(run):
    rec = spans.latest()
    if rec is None or not run.jobs:
        return None
    syncs = [n for name, n in rec.counters.items()
             if name.startswith("sync.")]
    if not syncs:
        return None
    return sum(syncs) / run.jobs
