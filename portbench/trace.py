"""What a torch.profiler trace of the measured window says.

The window runs under `torch.profiler` inside a `record_function` span,
`WINDOW`. On a card the profiler records the CUDA activity alone: the
device's kernels, copies and memsets and the host's CUDA runtime calls;
the torch operators' own host events (millions a Groth16 proof) would
double the profiler's cost and push a traced run past its time limit.
Where the span is not among the events, the window is the span of all of
them, from the first runtime call to the end of the last device event.
Without a card (the CPU tests) the profiler records the host's operators.
`summarize` reads the profiler's events directly, without writing a trace
file, and gives:

  busy_s       the union of the device's kernel, copy and memset intervals
               inside the window;
  kernels      device seconds and launches by kernel name;
  launches     device kernels run in the window;
  host_syncs   runtime calls that block the host until the device is done
               (stream, device and event synchronize; synchronous copies);
  idle_gaps    the device's idle time inside the window, filed under the
               innermost host event (on a card, a CUDA runtime call) that
               was running at each gap's midpoint, or OUTSIDE where none
               was: the host was in the program's Python or in torch's
               dispatch.

The arithmetic follows the repository's `scripts/torch_trace.py`, with one
change: a device-to-host copy is not counted as a wait of its own, since
torch waits for it with a stream synchronize that is counted already.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "portbench.window"
OUTSIDE = "no runtime call (python, torch dispatch)"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    host_syncs: int
    kernels: dict = field(default_factory=dict)  # name -> [seconds, launches]
    idle_gaps: dict = field(default_factory=dict)  # host event -> seconds

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds `fragment`."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if fragment in name)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, v[0]) for k, v in self.kernels.items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], s] for k, s in ops],
                "idle_gaps": [[k[:160], s] for k, s in gaps]}


@contextlib.contextmanager
def profiled():
    """Profile the body (CUDA activity on a card, CPU activity without
    one); yields the profiler."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[
            act.CUDA if torch.cuda.is_available() else act.CPU]) as prof:
        yield prof


def _merge(starts, ends):
    """The union of intervals: (starts, ends) of the merged ones, sorted."""
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    a, b = starts[order], ends[order]
    reach = np.maximum.accumulate(b)
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(a)) - 1
    return a[first], reach[last]


def summarize(prof) -> TraceSummary:
    cpu = torch.autograd.DeviceType.CPU
    device, host, window = [], [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.duration_ns(), e.name())
        if e.device_type() != cpu:
            device.append(row)
        elif row[2] == WINDOW:
            window.append(row)
        else:
            host.append(row)
    if len(window) > 1:
        raise RuntimeError(f"expected one {WINDOW} span, found {len(window)}")
    if not (window or device or host):
        raise RuntimeError("the profiler recorded nothing")
    if window:
        w0, w1 = window[0][0], window[0][0] + window[0][1]
    else:
        w0 = min(r[0] for r in device + host)
        w1 = max(r[0] + r[1] for r in device + host)
    kernels: dict[str, list] = {}
    starts, ends = [], []
    for a, d, name in device:
        a, b = max(a, w0), min(a + d, w1)
        if b <= a:
            continue
        starts.append(a)
        ends.append(b)
        if not name.startswith(("Memcpy", "Memset")):
            k = kernels.get(name)
            if k is None:
                k = kernels[name] = [0.0, 0]
            k[0] += (b - a) * 1e-9
            k[1] += 1
    host = [h for h in host if w0 <= h[0] <= w1]
    syncs = sum(1 for h in host if h[2] in SYNC_CALLS)
    bs, be = _merge(np.array(starts, dtype=np.int64),
                    np.array(ends, dtype=np.int64))
    gap_a = np.concatenate([[w0], be])
    gap_b = np.concatenate([bs, [w1]])
    keep = gap_b > gap_a
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9, busy_s=float((be - bs).sum()) * 1e-9,
        launches=sum(k[1] for k in kernels.values()), host_syncs=syncs,
        kernels=kernels, idle_gaps=_file_gaps(gap_a[keep], gap_b[keep], host))


def _file_gaps(gap_a, gap_b, host) -> dict[str, float]:
    """Seconds of idle gaps (sorted, disjoint) by the innermost host event,
    (start, duration, name), that covers each gap's midpoint: the events
    in the order they start each claim the midpoints they cover, so the
    latest start, the innermost, keeps a midpoint."""
    mids = (gap_a + gap_b) // 2
    owner = np.full(len(mids), -1, dtype=np.int64)
    host = sorted(host)
    if host:
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = hs + np.array([h[1] for h in host], dtype=np.int64)
        lo = np.searchsorted(mids, hs, side="left")
        hi = np.searchsorted(mids, he, side="right")
        for k in np.flatnonzero(hi > lo):
            owner[lo[k]:hi[k]] = k
    seconds = np.bincount(owner + 1, weights=(gap_b - gap_a) * 1e-9,
                          minlength=1)
    out: dict[str, float] = {}
    for k in np.flatnonzero(seconds):
        name = OUTSIDE if k == 0 else host[k - 1][2]
        out[name] = out.get(name, 0.0) + float(seconds[k])
    return out
