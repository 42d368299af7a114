#!/usr/bin/env python3
"""Time K1 (cosnarks_tpu_torch/csrc/mont_mul.cu) over its tile sizes and
blocks per SM, on one CUDA card.

    python3 scripts/torch_k1_tile_sweep.py

For every tile (elements per block) and number of resident blocks per SM
that fit the SM's shared memory (4 x tile x 144 bytes a block), it launches
the kernel directly at 2^15, 2^17 and 2^20 products and at a ragged 2^17 + 5,
holds every output against `mont.mul_plain` limb for limb, and times each
shape with CUDA events around launches queued behind a 50 ms device sleep.
Prints one JSON line per configuration, then the card's name and power
limit. `ff/mont_kernel.py` takes its MUL_TILE and MUL_BLOCKS_PER_SM from
such a run.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SMEM_PER_SM = 227 * 1024
ROW_BYTES = 144


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1 tile sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cosnarks_tpu_torch import _build
    from cosnarks_tpu_torch.ff import mont, mont_kernel as mk
    from cosnarks_tpu_torch.ff.spec import BN254_FQ

    dev = torch.device("cuda")
    sms = mk.sm_count(dev.index or 0)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    lib = _build.load("mont_mul")
    params = mk.field_params(BN254_FQ)
    gen = torch.Generator(device=dev).manual_seed(0x711E)
    n_max = 1 << 20
    a, b = (torch.randint(0, 1 << 16, (n_max, 16), generator=gen,
                          device=dev, dtype=torch.int64) for _ in range(2))
    a[:, 15] &= 0x1FFF  # canonical: below 2^253 < p
    b[:, 15] &= 0x1FFF
    totals = (1 << 15, 1 << 17, (1 << 17) + 5, n_max)
    refs = {n: mont.mul_plain(BN254_FQ, a[:n], b[:n]) for n in totals}

    def run(n, tile, blocks):
        out = torch.empty((n, 16), dtype=torch.int64, device=dev)
        mk.launch(lib.cosnarks_mont_mul, mk.ptr(a), mk.ptr(b), mk.ptr(out),
                  ctypes.c_int64(n), ctypes.c_int(tile),
                  ctypes.c_int(blocks), params)
        return out

    def timed(n, tile, blocks, iters):
        run(n, tile, blocks)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.05 * clock_hz))
        start.record()
        for _ in range(iters):
            run(n, tile, blocks)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for tile in (64, 128, 256):
        for per_sm in range(1, SMEM_PER_SM // (4 * tile * ROW_BYTES) + 1):
            row = {"tile": tile, "blocks_per_sm": per_sm}
            for n in totals:
                blocks = min(-(-n // tile), per_sm * sms)
                if not torch.equal(run(n, tile, blocks), refs[n]):
                    raise AssertionError(f"K1 differs at {row}, n = {n}")
                if n & (n - 1) == 0:
                    ms = timed(n, tile, blocks, 200 if n <= 1 << 15 else 20)
                    row[f"ms_{n}"] = ms
                    row[f"bound_share_{n}"] = (
                        3 * n * 128 / HBM_BYTES_PER_S * 1e3 / ms)
            print(json.dumps(row), flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
