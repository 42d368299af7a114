"""Where a warm 3-party Rep3 PLONK proof spends its time on one card.

    python3 scripts/torch_plonk_profile.py

Builds the kernels and sets up the chip_smoke.py phase `rep3_plonk`'s
domain-2^16 BN254 proof (`rep3_plonk_case` of
scripts/torch_plonk_fixture.py), proves once to warm the caches, then
proves again under torch.profiler (CPU and CUDA activities) and prints
one JSON line: the wall seconds of
the profiled proof (verification outside it), the device's busy seconds
(the union of its kernel, copy and memset intervals in the trace) and its
idle share of that wall time, device seconds by kernel name,
host seconds by operator (self CPU time), and the count of the runtime
calls that wait for the card (stream / device synchronize and
device-to-host copies). Needs one CUDA card; without one it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_seconds(intervals) -> float:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_plonk_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import cosnarks_tpu_torch as ct
    from cosnarks_tpu_torch import _build
    from cosnarks_tpu_torch.mpc.net.local import run_parties
    from cosnarks_tpu_torch.plonk import prove
    from torch_plonk_fixture import rep3_plonk_case

    dev = torch.device("cuda")
    ct.set_default_device(dev)
    _build.build()
    case = rep3_plonk_case(16, dev)
    zk = case.zk

    def party(net):
        drv, public, share = case.party(net)
        return prove.prove(zk, drv, public, share)

    def timed_proof():
        """(proofs, seconds) of one proof on three parties, the card
        synchronised at both ends."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs = run_parties([party] * 3)
        torch.cuda.synchronize()
        return proofs, time.perf_counter() - t0

    proofs, unprofiled = timed_proof()
    case.check(proofs)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        proofs, profiled = timed_proof()
    case.check(proofs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_kernel: dict[str, float] = {}
    for e in device:
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"] * 1e-6
    waits: dict[str, int] = {}
    for e in events:
        if ((e.get("cat") == "cuda_runtime" and "Synchronize" in e["name"])
                or (e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"])):
            waits[e["name"]] = waits.get(e["name"], 0) + 1
    busy = _union_seconds((e["ts"], e["ts"] + e["dur"]) for e in device)
    host_ops = sorted(
        ((a.key, a.self_cpu_time_total * 1e-6, a.count)
         for a in prof.key_averages()), key=lambda t: -t[1])[:25]
    print(json.dumps({
        "phase": "rep3_plonk_profile", "domain": zk.domain_size,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0],
        "unprofiled_prove_s": unprofiled, "profiled_prove_s": profiled,
        "device_busy_s": busy, "device_idle_share": 1.0 - busy / profiled,
        "device_events": len(device),
        "device_s_by_kernel": dict(sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])[:25]),
        "host_self_s_by_op": [{"op": k, "self_s": s, "calls": c}
                              for k, s, c in host_ops],
        "runtime_waits": waits,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
