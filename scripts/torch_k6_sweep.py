#!/usr/bin/env python3
"""Check and time K6 (the weighted bucket reduction) over its launch
geometries, on one CUDA card.

    python3 scripts/torch_k6_sweep.py [--quick] [--tree DIR]

Buckets are random canonical projective limbs with identity (0 : 1 : 0)
lanes on j = 5 mod 16, as in chip_smoke.py, on BN254 G1 (8 words) and
BLS12-381 G1 (12 words), at 20 x 4096 (2^16 points, c = 13), 17 x 16384
(2^20, c = 15) and 16 x 32768 (2^20, c = 16) buckets.

Default: at every P (segments a window) of 64-1024, the plain version at
that P (ec_kernels.wreduce_plain(..., segments=P)) once, then the kernel at
every (group, threads) of groups of 2, 4 and 8 threads in blocks of 64-256
through its C entry point (the wrapper takes no geometry), each held
against the plain version limb for limb and timed over 5 launches queued
behind a 50 ms device sleep (CUDA events). Each line carries the RCB ops a
window (ec_kernels.wreduce_work) over the 2 (W - 1) adds the sum needs.
--quick: 2 x 4096 buckets at the table's geometry and at every group,
checked and not timed.
--tree DIR: also time the weighted_bucket_sum of the cosnarks_tpu_torch in
DIR (an older checkout unpacked under build/) at the 8-word shapes through
its own wrapper, in a child process, on the same kind of buckets, so both
trees are timed in one call (chip_smoke.py of that tree checks it).

Prints one JSON line per case, then the fastest geometry per width and
shape, then the card's name and power limit; exits 1 if any case differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENTS = (64, 128, 256, 512, 1024)
GEOMETRIES = [(g, t) for g in (2, 4, 8) for t in (64, 128, 256)]
SHAPES = ((20, 4096), (17, 16384), (16, 32768))
# Times K6 of the cosnarks_tpu_torch in the working directory (--tree).
TREE_TIMING = """
import json, sys, torch
sys.path.insert(0, ".")
from cosnarks_tpu_torch.ec import ec_kernels as ek
from cosnarks_tpu_torch.ec.curves import BN254_G1 as g1
from cosnarks_tpu_torch.ff import mont
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0x6C6)
for nwin, W in %r:
    bk = [torch.randint(0, 1 << 16, (nwin, W, 16), generator=gen,
                        device=dev, dtype=torch.int64) for _ in range(3)]
    for x in bk:
        x[..., 15] &= 0x1FFF
    ident = (torch.arange(W, device=dev) %% 16 == 5)[None, :, None]
    one = mont.broadcast_one(g1.ops.field, (), device=dev)
    bk = [torch.where(ident, torch.zeros_like(bk[0]), bk[0]),
          torch.where(ident, one.expand_as(bk[1]), bk[1]),
          torch.where(ident, torch.zeros_like(bk[2]), bk[2])]
    ek.weighted_bucket_sum(g1, bk)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.05 * %r))
    start.record()
    for _ in range(5):
        ek.weighted_bucket_sum(g1, bk)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"tree": %r, "words": 8, "shape": [nwin, W],
                      "ms": start.elapsed_time(end) / 5}), flush=True)
"""


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--tree")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k6 sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cosnarks_tpu_torch import _build
    from cosnarks_tpu_torch.ec import ec_kernels as ek
    from cosnarks_tpu_torch.ec.curves import BLS12_381_G1, BN254_G1
    from cosnarks_tpu_torch.ff import mont
    from cosnarks_tpu_torch.ff import mont_kernel as mk

    dev = torch.device("cuda")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    gen = torch.Generator(device=dev).manual_seed(0x6C6)
    _build.build()
    emit({"registers": {f"wreduce ({w} words)": _build.resource_usage(
        "wreduce", w) for w in _build.WIDTHS}})
    sleep_s = 0.05

    def timed(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * clock_hz))
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / iters

    def buckets(g1, nwin, W):
        n = g1.ops.field.nlimbs
        top = (g1.ops.field.p >> (16 * (n - 1))).bit_length()
        bk = []
        for _ in range(3):
            x = torch.randint(0, 1 << 16, (nwin, W, n), generator=gen,
                              device=dev, dtype=torch.int64)
            x[..., n - 1] &= (1 << (top - 1)) - 1
            bk.append(x)
        one = mont.broadcast_one(g1.ops.field, (), device=dev)
        ident = (torch.arange(W, device=dev) % 16 == 5)[None, :, None]
        return [torch.where(ident, torch.zeros_like(bk[0]), bk[0]),
                torch.where(ident, one.expand_as(bk[1]), bk[1]),
                torch.where(ident, torch.zeros_like(bk[2]), bk[2])]

    def run_geometry(g1, bk, P, group, threads):
        nwin, W, n = bk[0].shape
        words = n // 2
        out = [torch.empty((nwin, n), dtype=torch.int64, device=dev)
               for _ in range(3)]
        scratch = torch.empty((nwin, P, 3 * words), dtype=torch.int32,
                              device=dev)
        lib = _build.load("wreduce", words)
        mk.launch(lib.cosnarks_wreduce, *[mk.ptr(b) for b in bk],
                  *[mk.ptr(x) for x in out], mk.ptr(scratch),
                  ctypes.c_int64(nwin), ctypes.c_int64(W), ctypes.c_int64(P),
                  ctypes.c_int(3 * g1.b), ctypes.c_int(group),
                  ctypes.c_int(threads), mk.field_params(g1.ops.field))
        return tuple(out)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    failed, best = 0, {}
    shapes = ((2, 4096),) if args.quick else SHAPES
    for g1 in (BN254_G1, BLS12_381_G1):
        words = g1.ops.field.nlimbs // 2
        for nwin, W in shapes:
            bk = buckets(g1, nwin, W)
            table = ek.wreduce_geometry(W, words)
            segments = (table[0],) if args.quick else [
                P for P in SEGMENTS if P <= W]
            for P in segments:
                ref = ek.wreduce_plain(g1, tuple(bk), segments=P)
                work = ek.wreduce_work(W, P)
                ratio = sum(work.values()) / (2 * (W - 1))
                for group, threads in GEOMETRIES:
                    if args.quick and threads != table[2]:
                        continue
                    case = {"words": words, "shape": [nwin, W], "P": P,
                            "group": group, "threads": threads,
                            "table": (P, group, threads) == table,
                            "work_ratio": ratio}
                    try:
                        fn = (lambda P=P, group=group, threads=threads:
                              run_geometry(g1, bk, P, group, threads))
                        if args.quick:
                            out, ms = fn(), None
                            torch.cuda.synchronize()
                        else:
                            out, ms = timed(fn)
                    except RuntimeError as e:  # refused (shared memory)
                        emit({**case, "refused": str(e)})
                        continue
                    ok = same(out, ref)
                    failed += not ok
                    emit({**case, "ms": ms, "equal": ok})
                    key = f"{words}w {nwin}x{W}"
                    if ok and ms is not None and (
                            key not in best or ms < best[key]["ms"]):
                        best[key] = {"P": P, "group": group,
                                     "threads": threads, "ms": ms,
                                     "work_ratio": ratio}
                del ref
            del bk
            torch.cuda.empty_cache()
    if args.tree:
        tree = os.path.abspath(args.tree)
        subprocess.run([sys.executable, "-c", TREE_TIMING % (
            SHAPES[:2], clock_hz, tree)], cwd=tree, check=True)
    emit({"best": best})
    print(smi("name,power.limit"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
