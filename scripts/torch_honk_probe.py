#!/usr/bin/env python3
"""Where a warm 3-party Rep3 co-UltraHonk proof at 2^16 rows spends its
time on one card.

    python3 scripts/torch_honk_probe.py [--device cpu]

Builds the kernels and proves the synthetic Noir program of chip_smoke.py's
phase rep3_noir_honk (`noir.synthetic.SMOKE_PROGRAM`, 2^16 rows) on a CRS
made on the device: once plain (Keccak, the reference, verified), once as
three Rep3 parties from a dealer split (`share_proving_key`) to warm the
caches, then once more under torch.profiler. Each co-proof must equal the
plain proof. Prints one JSON line a step (seconds, the prover's parts,
kernel launches, peak device memory); the profiled step adds, through
scripts/torch_trace.py, the device's busy seconds and idle share of the
proof's wall time, device seconds by kernel, host seconds by operator and
the runtime calls that wait for the card. With `--device cpu` it rehearses
the steps on a 256-row program, profiling the host only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_inputs=8, n_square=8, n_linear=8, n_big=2, n_range=0,
             n_logic=0, n_poseidon=1, n_reads=4)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch

    import cosnarks_tpu_torch as ct
    import torch_trace
    from cosnarks_tpu_torch import _build
    from cosnarks_tpu_torch.ec import ec_kernels as ek
    from cosnarks_tpu_torch.ff import mont_kernel
    from cosnarks_tpu_torch.honk import builder as hbuilder
    from cosnarks_tpu_torch.honk import co_prover as hco
    from cosnarks_tpu_torch.honk import crs as hcrs
    from cosnarks_tpu_torch.honk import prover as hprover
    from cosnarks_tpu_torch.honk import proving_key as hpk
    from cosnarks_tpu_torch.honk import transcript as ht
    from cosnarks_tpu_torch.honk import verifier as hverifier
    from cosnarks_tpu_torch.honk.co_driver import Rep3HonkDriver
    from cosnarks_tpu_torch.honk.polyops import FR
    from cosnarks_tpu_torch.mpc import rep3
    from cosnarks_tpu_torch.mpc.net.local import run_parties
    from cosnarks_tpu_torch.noir import acir, solver, synthetic
    from cosnarks_tpu_torch.vm.interp import PlainDriver

    dev = ct.resolve_device(args.device)
    cuda = dev.type == "cuda"
    counters = (mont_kernel.mul, ek.jacobian_launch, ek.proj_launch,
                ek.fold_launch)
    keccak = ht.HASHERS["keccak"]

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def start():
        for c in counters:
            c.launches.clear()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def stop(t0):
        sync()
        return {"seconds": time.perf_counter() - t0,
                "launches": {c.__qualname__: sum(c.launches.values())
                             for c in counters},
                "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                      if cuda else None)}

    if cuda:
        t0 = time.perf_counter()
        _build.build()
        emit({"step": "build", "seconds": time.perf_counter() - t0,
              "card": torch.cuda.get_device_name(0)})
    program = synthetic.SMOKE_PROGRAM if cuda else SMALL
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.json")
        acir.dump_artifact(path, *synthetic.synthetic_program(**program))
        art = acir.load_artifact(path)
    af = hbuilder.AcirFormat.from_function(art.functions[0])
    wmap = solver.solve_program(
        art, PlainDriver(FR), FR.p,
        synthetic.synthetic_inputs(program["n_inputs"], 5))
    wit = [int(wmap.get(i, 0)) for i in range(af.max_witness_index + 1)]
    pk = hpk.create_proving_key(hbuilder.UltraBuilder.create_circuit(af,
                                                                     wit))
    emit({"step": "host key", "seconds": time.perf_counter() - t0,
          "rows": pk.circuit_size})
    t0 = start()
    pkd = pk.to_device(dev)
    crs = hcrs.local_crs(pk.circuit_size, device=dev)
    vk = hpk.create_vk(pkd, crs)
    emit({"step": "key to device, CRS, vk", **stop(t0)})
    parts = {}
    t0 = start()
    plain = hprover.prove(pkd, vk, crs, keccak, timings=parts)
    emit({"step": "plain keccak", "parts": parts, **stop(t0),
          "words": len(plain[0])})
    if not hverifier.verify(*plain, vk, crs.g2_x, keccak):
        raise AssertionError("plain proof refused")
    witness = [hco.shared_witness_to_device(s, dev)
               for s in hco.share_proving_key(pk, None)]

    def party(net):
        drv = Rep3HonkDriver(net, rep3.Rep3State.setup(
            net, bytes([net.id + 3]) * 32, device=dev))
        parts = {}
        proof = hco.co_prove(pkd, witness[net.id], vk, crs, keccak, drv,
                             timings=parts)
        return proof, parts, drv.rounds

    def co_proof():
        t0 = start()
        res = run_parties([party] * 3)
        out = stop(t0)
        if not all(r[0] == plain for r in res):
            raise AssertionError("co-proof != plain Keccak proof")
        return {**out, "parts_by_party": [r[1] for r in res],
                "rounds": res[0][2]}

    emit({"step": "co_prove, 3 parties (warm-up)", **co_proof()})
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = co_proof()
    summary = torch_trace.summarize(prof, out["seconds"])
    if not cuda:  # no device in the trace: keep the host's numbers only
        summary = {"host_self_s_by_op": summary["host_self_s_by_op"]}
    emit({"step": "co_prove under torch.profiler", **out, **summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
