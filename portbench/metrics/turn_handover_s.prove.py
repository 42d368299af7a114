"""Seconds a proof in which no party held the card's turn: the traced
window's seconds less the parties' turn holds (the program's `mpc.turn`
spans, `mpc/net/base.py` Turn), over the proofs."""

from portbench import spans

NEEDS = ()


def read(run):
    rec = spans.latest()
    if rec is None or not run.jobs:
        return None
    holds = [s for s in rec.spans if s.name == "mpc.turn"]
    if not holds:
        return None
    held_s = sum(s.end_ns - s.start_ns for s in holds) * 1e-9
    return (run.window_s - held_s) / run.jobs
