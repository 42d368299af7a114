"""Seconds a proof in PLONK's round 3, the quotient polynomial: the
parties' `prove.round3` spans' self time (the party's own, its turn held;
`groth16/prove.py` `_Clock`), summed over the parties, over the proofs."""

from portbench import spans

NEEDS = ()


def read(run):
    rec = spans.latest()
    if rec is None or not run.jobs:
        return None
    rounds = [s for s in rec.spans if s.name == "prove.round3"]
    if not rounds:
        return None
    return sum(s.self_ns for s in rounds) * 1e-9 / run.jobs
