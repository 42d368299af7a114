"""Bytes the three parties send a proof: the program's counter
`mpc.sent_bytes` (`mpc/net/base.py`, each message at the size the socket
transports put on the wire), summed over the parties, over the proofs."""

from portbench import spans

NEEDS = ()


def read(run):
    rec = spans.latest()
    if rec is None or not run.jobs:
        return None
    n = rec.counters.get("mpc.sent_bytes")
    if n is None:
        return None
    return n / run.jobs
