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
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    import torch_trace
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
    print(json.dumps({
        "phase": "rep3_plonk_profile", "domain": zk.domain_size,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0],
        "unprofiled_prove_s": unprofiled, "profiled_prove_s": profiled,
        **torch_trace.summarize(prof, profiled),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
