"""Seconds a proof in the co-UltraHonk sumcheck: the parties'
`prove.sumcheck` spans' self time (the party's own, its turn held;
`honk/co_prover.py` through `groth16/prove.py` `_Clock`), summed over the
parties, over the proofs."""

from portbench import spans

NEEDS = ()


def read(run):
    rec = spans.latest()
    if rec is None or not run.jobs:
        return None
    rounds = [s for s in rec.spans if s.name == "prove.sumcheck"]
    if not rounds:
        return None
    return sum(s.self_ns for s in rounds) * 1e-9 / run.jobs
