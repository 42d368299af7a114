#!/usr/bin/env python3
"""Time K3's projective add at 2^14 points alone and right after K1 or K2
launches, on one CUDA card.

    python3 scripts/torch_k3_after_k2.py

K1 and K2 take dynamic shared memory (up to 72 KB and 50 KB a block); K3
takes none and reads its operands 8 bytes at a time, 128 bytes apart per
thread, leaning on L1. If the SM keeps the larger shared-memory carveout of
the kernel before it, K3 runs with less L1. For each case the script
launches the named kernel once, synchronises, then times 20 and (after
launching it again) 200 K3 adds queued behind a 50 ms device sleep with
CUDA events, and repeats the whole list three times. Prints one JSON line
per case, count and round, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3 after k2: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cosnarks_tpu_torch.ec import ec_kernels as ek
    from cosnarks_tpu_torch.ec.curves import BN254_G1 as g1
    from cosnarks_tpu_torch.ff import mont_kernel
    from cosnarks_tpu_torch.ff.spec import BN254_FQ

    dev = torch.device("cuda")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    gen = torch.Generator(device=dev).manual_seed(0x3A2)

    def rand_fe(n):
        x = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=dev,
                          dtype=torch.int64)
        x[:, 15] &= 0x1FFF
        return x

    n = 1 << 14
    pts = [rand_fe(n) for _ in range(6)]
    big = [rand_fe(1 << 20) for _ in range(2)]
    before = {
        "alone": lambda: None,
        "after K2 add, 2^14 points": lambda: ek.jacobian_launch(
            g1, ek.JAC_ADD, pts),
        "after K2 add, 1 point": lambda: ek.jacobian_launch(
            g1, ek.JAC_ADD, [c[:1] for c in pts]),
        "after K1, 2^20 products": lambda: mont_kernel.mul(BN254_FQ, *big),
        "after a torch op": lambda: pts[0] + pts[1],
    }
    for rnd in range(3):
        for case, first in before.items():
            for iters in (20, 200):
                first()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(int(0.05 * clock_hz))
                start.record()
                for _ in range(iters):
                    ek.proj_launch(g1, ek.PROJ_ADD, pts)
                end.record()
                torch.cuda.synchronize()
                print(json.dumps({"round": rnd, "case": case, "iters": iters,
                                  "k3_add_ms":
                                  start.elapsed_time(end) / iters}),
                      flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
