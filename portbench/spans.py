"""What the program recorded of itself in the traced window: the spans and
counters of `cosnarks_tpu_torch/utils/timing.py`, which records while a
torch profiler runs, so the harness's traced window is one recording
session. Each span is (name, party, thread, start_ns, end_ns, self_ns).
Where the program has no such facility, or recorded nothing, `latest`
gives None and the readers that use it find nothing."""

from __future__ import annotations

import bisect
from collections import defaultdict


def latest():
    """The program's latest recording session, or None."""
    try:
        from cosnarks_tpu_torch.utils import timing
    except ImportError:
        return None
    record = getattr(timing, "record", None)
    if record is None:
        return None
    rec = record()
    if not rec.spans and not rec.counters:
        return None
    return rec


def outermost(spans, name: str) -> list:
    """The spans called `name` that lie inside no other of that name on
    their thread."""
    out = []
    by_thread = defaultdict(list)
    for s in spans:
        if s.name == name:
            by_thread[s.thread].append(s)
    for group in by_thread.values():
        group.sort(key=lambda s: (s.start_ns, -s.end_ns))
        reach = None
        for s in group:
            if reach is None or s.start_ns >= reach:
                out.append(s)
                reach = s.end_ns
    return sorted(out, key=lambda s: s.start_ns)


def nanoseconds_inside(outer, spans) -> int:
    """Nanoseconds of `spans` (one thread's, sorted by start; disjoint)
    that lie inside `outer`."""
    starts = [s.start_ns for s in spans]
    i = bisect.bisect_left(starts, outer.start_ns)
    total = 0
    while i < len(spans) and spans[i].start_ns < outer.end_ns:
        if spans[i].end_ns <= outer.end_ns:
            total += spans[i].end_ns - spans[i].start_ns
        i += 1
    return total
