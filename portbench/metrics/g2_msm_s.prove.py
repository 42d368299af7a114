"""Seconds of the three parties' `g2_msm` phase a proof, from the prover's
own phase clock (`prove(timings=)`). A party holds the card's turn through
its local phases, so this is its own time on the G2 MSM. No cell names it
yet: it waits, with the Groth16 proof job, for a Groth16 proof cell
(PERF.md, Open questions)."""

NEEDS = ("party_timings",)


def read(run):
    ts = [t["g2_msm"] for t in run.counters.timings if "g2_msm" in t]
    if not ts or not run.jobs:
        return None
    return sum(ts) / run.jobs
