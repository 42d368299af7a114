"""What a torch.profiler trace of one card says, shared by
scripts/torch_plonk_profile.py and scripts/torch_honk_probe.py.

`summarize(prof, wall_s)` exports the trace and returns the device's busy
seconds (the union of its kernel, copy and memset intervals) and its idle
share of `wall_s`, the count of device events, device seconds by kernel
name, host seconds by operator (self CPU time) and the count of the
runtime calls that wait for the card (stream / device synchronize and
device-to-host copies).
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_seconds(intervals) -> float:
    """Total length of the union of (start, end) intervals (microseconds
    in, seconds out)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def summarize(prof, wall_s: float, top: int = 25) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_kernel: dict[str, float] = {}
    for e in device:
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"] * 1e-6
    waits: dict[str, int] = {}
    for e in events:
        if ((e.get("cat") == "cuda_runtime" and "Synchronize" in e["name"])
                or (e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"])):
            waits[e["name"]] = waits.get(e["name"], 0) + 1
    busy = union_seconds((e["ts"], e["ts"] + e["dur"]) for e in device)
    host_ops = sorted(
        ((a.key, a.self_cpu_time_total * 1e-6, a.count)
         for a in prof.key_averages()), key=lambda t: -t[1])[:top]
    return {
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall_s,
        "device_events": len(device),
        "device_s_by_kernel": dict(sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])[:top]),
        "host_self_s_by_op": [{"op": k, "self_s": s, "calls": c}
                              for k, s, c in host_ops],
        "runtime_waits": waits,
    }
