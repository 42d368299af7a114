#!/usr/bin/env python3
"""Check and time K5 (the complete Jacobian + affine mixed add) over its
launch geometries, on one CUDA card.

    python3 scripts/torch_k5_sweep.py [--quick] [--tree DIR]

Operands as in chip_smoke.py: random canonical limbs for a Jacobian P and
an affine Q, with P = Q (X1 = x2 Z1^2, Y1 = y2 Z1^3) on lanes 1 mod 8,
P = -Q on lanes 2 mod 8 and P = inf on lanes 3 mod 8; the masked mode
drops lanes 0 mod 4. On BN254 G1 (8 words) and BLS12-381 G1 (12 words), at
1, 32, 2^14, 2^17 and 2^20 points, unmasked and masked.

Default: the plain version (ec_kernels.madd_plain) once per case, then the
kernel at every (group, threads) it is built for, groups of 2 and 4
threads in blocks of 64-256, through its C entry point (the wrapper takes
no geometry), each held against the plain version limb for limb and timed
over 20-200 launches queued behind a 50 ms device sleep (CUDA events). Each
line carries the case's bound (chip_smoke.py's: the bytes of 5 coordinates
in and 3 out, and the mask, over 3.35 TB/s).
--quick: 1, 33 and 2^14 points at every geometry, checked and not timed.
--tree DIR: the same cases through the wrapper (ec_kernels.madd_launch) of
the cosnarks_tpu_torch in DIR, at that tree's own geometry, so that an
older tree unpacked under build/ is timed in the same call.

Prints one JSON line per case, then the fastest geometry per width, shape
and mode, then the card's name and power limit; exits 1 if any case
differs from its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = [(g, t) for g in (2, 4) for t in (64, 128, 256)]
SHAPES = (1, 32, 1 << 14, 1 << 17, 1 << 20)
QUICK_SHAPES = (1, 33, 1 << 14)
HBM_BYTES_PER_S = 3.35e12  # as chip_smoke.py


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
        print("k5 sweep: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree or ROOT)
    sys.path.insert(0, tree)
    from cosnarks_tpu_torch import _build
    from cosnarks_tpu_torch.ec import ec_kernels as ek
    from cosnarks_tpu_torch.ec.curves import BLS12_381_G1, BN254_G1
    from cosnarks_tpu_torch.ff import mont
    from cosnarks_tpu_torch.ff import mont_kernel as mk

    dev = torch.device("cuda")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    _build.build()
    emit({"tree": tree, "registers": {
        f"jacobian_madd ({w} words)": _build.resource_usage(
            "jacobian_madd", w) for w in _build.WIDTHS}})
    sleep_s = 0.05

    def timed(fn, iters):
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

    def operands(g1, total):
        """(P, affine Q, mask) with chip_smoke.py's edge lanes."""
        F, n = g1.ops.field, g1.ops.field.nlimbs
        gen = torch.Generator(device=dev).manual_seed(0x5E5)
        top = (F.p >> (16 * (n - 1))).bit_length()

        def rand():
            x = torch.randint(0, 1 << 16, (total, n), generator=gen,
                              device=dev, dtype=torch.int64)
            x[:, n - 1] &= (1 << (top - 1)) - 1
            return x

        P = [rand() for _ in range(3)]
        Q = [rand() for _ in range(2)]
        lane = torch.arange(total, device=dev)
        Zsq = mont.mul(F, P[2], P[2])
        Xs = mont.mul(F, Q[0], Zsq)
        Ys = mont.mul(F, Q[1], mont.mul(F, Zsq, P[2]))
        same = (lane % 8 == 1)[:, None]
        minus = (lane % 8 == 2)[:, None]
        P = [torch.where(same | minus, Xs, P[0]),
             torch.where(same, Ys, torch.where(minus, mont.neg(F, Ys),
                                               P[1])),
             torch.where((lane % 8 == 3)[:, None], torch.zeros_like(P[2]),
                         P[2])]
        valid = (lane % 4 != 0).to(torch.int64)
        return ([x.contiguous() for x in P], [x.contiguous() for x in Q],
                valid.contiguous())

    def run_geometry(g1, coords, valid, group, threads):
        total, n = coords[0].shape
        out = [torch.empty_like(coords[0]) for _ in range(3)]
        points = threads // group
        lib = _build.load("jacobian_madd", n // 2)
        mk.launch(lib.cosnarks_jacobian_madd, ctypes.c_int(int(
            valid is not None)), *[mk.ptr(c) for c in coords],
            mk.ptr(valid) if valid is not None else None,
            *[mk.ptr(o) for o in out], ctypes.c_int64(total),
            ctypes.c_int(group), ctypes.c_int(threads),
            ctypes.c_int(-(-total // points)), mk.field_params(g1.ops.field))
        return tuple(out)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    failed, best = 0, {}
    shapes = QUICK_SHAPES if args.quick else SHAPES
    for g1 in (BN254_G1, BLS12_381_G1):
        n = g1.ops.field.nlimbs
        words = n // 2
        P, Q, valid = operands(g1, max(shapes))
        for total in shapes:
            coords = [x[:total] for x in P + Q]
            for masked in (False, True):
                vm = valid[:total] if masked else None
                ref = ek.madd_plain(g1, tuple(coords[:3]), tuple(coords[3:]),
                                    None if vm is None else vm != 0)
                nbytes = 8 * total * n * 8 + (total * 8 if masked else 0)
                case = {"words": words, "points": total, "masked": masked,
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
                iters = 200 if total <= 1 << 14 else 20
                if args.tree:
                    fns = {"wrapper": lambda: ek.madd_launch(g1, coords, vm)}
                else:
                    fns = {(g, t): (lambda g=g, t=t: run_geometry(
                        g1, coords, vm, g, t)) for g, t in GEOMETRIES}
                for geometry, fn in fns.items():
                    row = dict(case, tree=tree) if args.tree else dict(
                        case, group=geometry[0], threads=geometry[1],
                        table=ek.madd_geometry(total, words)[:2] == geometry)
                    if args.quick:
                        out, ms = fn(), None
                        torch.cuda.synchronize()
                    else:
                        out, ms = timed(fn, iters)
                    ok = same(out, ref)
                    failed += not ok
                    emit({**row, "ms": ms, "equal": ok})
                    key = f"{words}w {total}{' masked' if masked else ''}"
                    if ok and ms is not None and not args.tree and (
                            key not in best or ms < best[key]["ms"]):
                        best[key] = {"group": geometry[0],
                                     "threads": geometry[1], "ms": ms}
                    del out
                del ref
        del P, Q, valid
        torch.cuda.empty_cache()
    emit({"best": best})
    print(smi("name,power.limit"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
