"""The host's own milliseconds an MSM, not blocked on the card: the mean
over the window's MSMs of the outermost `msm` span (`ec/msm.py`) less the
`sync.*` spans of its thread inside it (the program's host-blocking
points, `utils/timing.blocking`)."""

from collections import defaultdict

from portbench import spans

NEEDS = ()


def read(run):
    rec = spans.latest()
    if rec is None:
        return None
    msms = spans.outermost(rec.spans, "msm")
    if not msms:
        return None
    syncs = defaultdict(list)
    for s in rec.spans:
        if s.name.startswith("sync."):
            syncs[s.thread].append(s)
    for group in syncs.values():
        group.sort(key=lambda s: s.start_ns)
    own = [m.end_ns - m.start_ns
           - spans.nanoseconds_inside(m, syncs.get(m.thread, []))
           for m in msms]
    return sum(own) / len(own) * 1e-6
