"""Flagship run: a 2^20-constraint, 3-party Rep3 BN254 Groth16 proof,
verified (the port's counterpart of scripts/flagship_groth16.py).

    python -m cosnarks_tpu_torch.flagship [--logn 20] [--device cuda]

Builds (once, cached under build/zkeys) the synthetic zkey of a squaring
chain of 2^logn - 2 constraints (domain 2^logn), shares its witness among
three Rep3 parties, proves twice with the parties as threads over
LocalNetwork on one card, taking turns, checks that every party returns
the same proof and that each proof verifies, and prints one JSON line: the
JAX script's keys (metric, value, unit, prove_wall_s,
first_run_incl_compile_s, verified) and the port's own (device, card,
kernel build, zkey seconds, each party's phase seconds, peak device
memory, kernel launches by mode).

Runs on the CUDA card unless given `--device cpu`; with no card and no
`--device cpu` it raises before any work.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import threading
import time

import torch

from . import _build, resolve_device
from .groth16 import drivers, prove, setup
from .groth16.verify import verify_bn254
from .mpc import rep3
from .mpc.net.local import run_parties
from .utils import timing

SHARE_SEED = 0xF1A6  # the JAX script's share RNG
PARTY_TIMEOUT_S = 7200.0  # the JAX script's


def card(device) -> str | None:
    """The card's name and power limit as nvidia-smi prints them; None on
    the CPU."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _peak_reset(device):
    """Peak device bytes since the last call (None on the CPU), then a new
    peak window."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def _launch_diff(after: dict, before: dict) -> dict:
    return {fn: {k: n - before.get(fn, {}).get(k, 0)
                 for k, n in modes.items()
                 if n != before.get(fn, {}).get(k, 0)}
            for fn, modes in after.items()}


def build_zkey(logn: int, device) -> dict:
    """setup.cached_synthetic_zkey(2^logn - 2) on `device`: the zkey, its
    witness, the seconds it took, whether the cache held it and the peak
    device bytes of the build."""
    ncon = (1 << logn) - 2  # domain = next_pow2(ncon + 2) = 2^logn
    hit = setup.cache_path(ncon).exists()
    _peak_reset(device)
    t0 = time.perf_counter()
    zkey, w = setup.cached_synthetic_zkey(ncon, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"zkey": zkey, "witness": w, "seconds": time.perf_counter() - t0,
            "cache_hit": hit, "peak_device_bytes": _peak_reset(device)}


def prove_parties(zkey, w, device, proves: int = 2) -> list[dict]:
    """Share `w` among three Rep3 parties (the JAX script's RNG; fixed PRF
    seeds) and prove `proves` times over run_parties, the parties taking
    turns on one device. A barrier between proves (waited on outside the
    party's turn) marks each prove's kernel launches and peak device bytes.
    Raises unless every party returns the same proof; one dict a prove:
    proof, verified, prove_wall_s (the slowest party's seconds, as the JAX
    script counts them), prove_s_by_party, phase_seconds_by_party (each
    party's `prove(timings=)`: the phases' self seconds, the party's own
    with its turn held, and its turn waits inside them under "turn_wait"),
    peak_device_bytes, launches_by_mode."""
    n_inst = zkey.n_public + 1
    shares = rep3.share_field_elements(zkey.fr, w[n_inst:],
                                       random.Random(SHARE_SEED),
                                       device=device)
    marks = []  # (launch counts, peak device bytes since the last mark)
    t_start = time.perf_counter()

    def mark():
        marks.append((timing.launch_counts(), _peak_reset(device)))
        if len(marks) > 1:
            print(f"flagship: prove {len(marks) - 1} of {proves} done at "
                  f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr,
                  flush=True)

    barrier = threading.Barrier(3, action=mark, timeout=PARTY_TIMEOUT_S)

    def party(net):
        try:
            state = rep3.Rep3State.setup(net, bytes([net.id + 1]) * 32,
                                          device=device)
            drv = drivers.Rep3Driver(net, state)
            wit = prove.SharedWitness(public_inputs=w[:n_inst],
                                      witness=shares[net.id])
            out = []
            for _ in range(proves):
                with net.turn.blocked():
                    barrier.wait()
                timings = {}
                t0 = time.perf_counter()
                proof = prove.prove(drv, zkey, wit, timings=timings)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                out.append((proof, time.perf_counter() - t0, timings))
            with net.turn.blocked():
                barrier.wait()
            return out
        except BaseException:
            barrier.abort()  # the other parties stop waiting for this one
            raise

    res = run_parties([party] * 3, timeout=PARTY_TIMEOUT_S)
    vk = prove.vk_from_zkey(zkey)
    runs = []
    for k in range(proves):
        proof = res[0][k][0]
        if not all(r[k][0] == proof for r in res):
            raise AssertionError(f"prove {k + 1}: parties disagree")
        prove_s = [r[k][1] for r in res]
        runs.append({
            "proof": proof,
            "verified": bool(verify_bn254(vk, proof, w[1:n_inst])),
            "prove_wall_s": max(prove_s), "prove_s_by_party": prove_s,
            "phase_seconds_by_party": [r[k][2] for r in res],
            "peak_device_bytes": marks[k + 1][1],
            "launches_by_mode": _launch_diff(marks[k + 1][0], marks[k][0])})
    return runs


def result_line(logn: int, device, card_name, build_s, zkey: dict,
                runs: list[dict]) -> dict:
    """The flagship's JSON line: the JAX script's keys, from the last
    prove (value, prove_wall_s) and the first (first_run_incl_compile_s),
    then the port's."""
    where = "1 card" if device.type == "cuda" else device.type
    last = runs[-1]
    return {
        "metric": f"Groth16 proofs/sec (2^{logn} constraints, 3-party "
                  f"Rep3, {where}, LocalNetwork)",
        "value": 1.0 / last["prove_wall_s"],
        "unit": "proofs/s",
        "prove_wall_s": last["prove_wall_s"],
        "first_run_incl_compile_s": runs[0]["prove_wall_s"],
        "verified": all(r["verified"] for r in runs),
        "device": str(device),
        "card": card_name,
        "kernel_build_s": build_s,
        "zkey_s": zkey["seconds"],
        "zkey_cache_hit": zkey["cache_hit"],
        "zkey_peak_device_bytes": zkey["peak_device_bytes"],
        "prove_s_by_party": [r["prove_s_by_party"] for r in runs],
        "phase_seconds_by_party": [r["phase_seconds_by_party"]
                                   for r in runs],
        "peak_device_bytes": [r["peak_device_bytes"] for r in runs],
        "launches_by_mode": last["launches_by_mode"],
    }


def run(logn: int = 20, device=None) -> dict:
    """The whole flagship: kernels (built on the card, timed apart), zkey,
    two proves (the JAX script's); returns `result_line`."""
    device = resolve_device(device)
    card_name = card(device)
    build_s = None
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.build()
        build_s = time.perf_counter() - t0
    zkey = build_zkey(logn, device)
    print(f"flagship: zkey 2^{logn} in {zkey['seconds']:.1f} s "
          f"(cache hit: {zkey['cache_hit']})", file=sys.stderr, flush=True)
    runs = prove_parties(zkey["zkey"], zkey["witness"], device, proves=2)
    return result_line(logn, device, card_name, build_s, zkey, runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cosnarks_tpu_torch.flagship",
        description="2^logn-constraint 3-party Rep3 BN254 Groth16, "
                    "proved twice and verified")
    ap.add_argument("--logn", type=int, default=20,
                    help="log2 of the domain (constraints 2^logn - 2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu on a "
                         "machine without a card)")
    args = ap.parse_args(argv)
    line = run(args.logn, args.device)
    print(json.dumps(line), flush=True)
    return 0 if line["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
