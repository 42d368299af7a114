#!/usr/bin/env python3
"""Check and time K3 and K4 over their group geometries, or at the launches
of a proof, on one CUDA card.

    python3 scripts/torch_rcb_group_sweep.py [--tree DIR]
                                            [--quick | --loss SMOKE_OUT]

Every case is held against its plain version limb for limb, then (but for
--quick) timed over 5-200 launches queued behind a 50 ms device sleep
(CUDA events).

Default: every K3 mode (add, madd, masked madd, double) at 1 to 2^17
points (each power of two: the launch-size buckets of the proofs) with
identity, P = Q and P = -Q lanes, and both K4 modes at the fold-lane counts
of the proofs at domain 2^16 (L = 160, 208, 2560, 3328, 40960, 53248;
K = 32) with chip_smoke.py's flag make, and at L = 160 on edge flag
patterns (every lane changed, every lane invalid, save-prefix on step 0),
at every (group, threads) geometry the kernels are built for: 2, 4 or 8
threads a point for K3, 2 or 8 a fold lane for K4, 64 to 256 a block,
through the kernels' C entry points.
--tree DIR: the same cases through the wrappers of the cosnarks_tpu_torch
in DIR, at that tree's own geometry, so that an older tree unpacked under
build/ is timed in the same call.
--quick: 1, 32 and 2^14 points, L = 160 and 2560 and the edge flag
patterns, checked and not timed.
--loss SMOKE_OUT: K3's add and double at every launch-size bucket and K4
at every (L, K) that the two proofs of a chip_smoke.py output launched
(`launch_sizes`, `fold_shapes`), through the wrappers of this checkout
(or DIR), at the tree's own geometry, each beside
its bound as chip_smoke.py's phase main_path_loss computes it; the last
JSON line holds the loss per proof and mode, sum of launches x (ms -
bound). So an older tree's loss is read at the same launches.

Prints one JSON line per case, then the card's name and power limit; exits
1 if any case differs from its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJ_GEOMETRIES = [(g, t) for g in (2, 4, 8) for t in (64, 128, 256)]
FOLD_GEOMETRIES = [(g, t) for g in (2, 8) for t in (64, 128, 256)]
FOLD_LANES = (160, 208, 2560, 3328, 40960, 53248)
K = 32
# the BN254 Groth16 proofs a chip_smoke.py output may hold: the main path
# (at 2^16 in older outputs, at 2^20 since) and the Shamir proof
PROOFS = ("rep3_groth16", "flagship_groth16_2p20", "shamir_groth16")
HBM_BYTES_PER_S = 3.35e12  # as chip_smoke.py
SMS, IMAD_PER_CLOCK, MULS_PER_FIELD_MUL = 132, 64, 264
LIMB_BYTES = 16 * 8


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def proof_launches(path):
    """{proof: (K3 {mode: {bucket: n}}, K4 {(proj_q, L, K): n})} from a
    chip_smoke.py output."""
    out = {}
    for line in open(path):
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") in PROOFS:
            folds = {}
            for key, n in d["fold_shapes"].items():
                m = re.fullmatch(r"(level 0|projective) L=(\d+) K=(\d+)", key)
                folds[(m.group(1) == "projective", int(m.group(2)),
                       int(m.group(3)))] = n
            out[d["phase"]] = ({k: v for k, v in d["launch_sizes"].items()
                                if k.startswith("K3")}, folds)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true")
    mode.add_argument("--loss", metavar="SMOKE_OUT")
    args = ap.parse_args()
    wrapped_only = bool(args.tree or args.loss)
    tree = os.path.abspath(args.tree or ROOT)

    import torch

    if not torch.cuda.is_available():
        print("rcb group sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    from cosnarks_tpu_torch import _build
    from cosnarks_tpu_torch.ec import ec_kernels as ek
    from cosnarks_tpu_torch.ec.curves import BN254_G1 as g1
    from cosnarks_tpu_torch.ff import mont
    from cosnarks_tpu_torch.ff import mont_kernel as mk
    from cosnarks_tpu_torch.ff.spec import BN254_FQ as F

    dev = torch.device("cuda")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    gen = torch.Generator(device=dev).manual_seed(0x6C3)
    _build.build()
    print(json.dumps({"tree": tree, "registers": {
        k: _build.resource_usage(k) for k in ("proj_op", "msm_fold")}}),
        flush=True)
    launches = proof_launches(args.loss) if args.loss else None
    proofs = tuple(launches) if args.loss else ()  # those it holds
    params, b3 = mk.field_params(F), 3 * g1.b

    def ptrs(ts):
        return [None if t is None else mk.ptr(t) for t in ts]

    def proj_direct(op, coords, valid, group, threads):
        """K3 through its C entry point at (group, threads)."""
        total = coords[0].shape[0]
        out = [torch.empty_like(coords[0]) for _ in range(3)]
        mk.launch(_build.load("proj_op").cosnarks_proj_op, ctypes.c_int(op),
                  *ptrs(list(coords) + [None] * (6 - len(coords))),
                  *ptrs([valid]), *ptrs(out), ctypes.c_int64(total),
                  ctypes.c_int(b3), ctypes.c_int(group),
                  ctypes.c_int(threads),
                  ctypes.c_int(-(-total // (threads // group))), params)
        return out

    def fold_direct(q, flags, k, proj_q, group, threads):
        """K4 through its C entry point at (group, threads)."""
        L = flags.shape[1]
        bufs = [torch.empty((16, k, L), dtype=torch.int64, device=dev)
                for _ in range(3)]
        lanes = [torch.empty((16, L), dtype=torch.int64, device=dev)
                 for _ in range(6)]
        mk.launch(_build.load("msm_fold").cosnarks_msm_fold,
                  ctypes.c_int(int(proj_q)),
                  *ptrs(list(q) + [None] * (3 - len(q))), mk.ptr(flags),
                  *ptrs(bufs + lanes), ctypes.c_int64(k), ctypes.c_int64(L),
                  ctypes.c_int(b3), ctypes.c_int(group),
                  ctypes.c_int(threads),
                  ctypes.c_int(-(-L // (threads // group))), params)
        return tuple(bufs), tuple(lanes[:3]), tuple(lanes[3:])

    def rand_fe(*shape):
        x = torch.randint(0, 1 << 16, shape + (16,), generator=gen,
                          device=dev, dtype=torch.int64)
        x[..., 15] &= 0x1FFF
        return x

    def timed(fn, iters):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.05 * clock_hz))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def bound_ms(nbytes, nfield_muls):
        return max(nbytes / HBM_BYTES_PER_S,
                   nfield_muls * MULS_PER_FIELD_MUL
                   / (SMS * IMAD_PER_CLOCK * clock_hz)) * 1e3

    def flat(ts):
        for t in ts:
            if isinstance(t, torch.Tensor):
                yield t
            else:
                yield from flat(t)

    def err(a, b):
        return max(int((x - y).abs().max()) for x, y in zip(flat(a), flat(b)))

    failed = []
    loss = {ph: {} for ph in proofs}

    def run_case(case, wrapped, direct, geometries, plain_out, iters, bound,
                 counts=None):
        """Check (and unless --quick time) one case: with --tree or --loss
        through the tree's wrapper (`wrapped()`), else through the C entry
        point (`direct(group, threads)`) at every geometry; with counts
        ({proof: launches}), add its loss."""
        for geo in [None] if wrapped_only else geometries:
            launch = wrapped if geo is None else lambda: direct(*geo)
            e = err(launch(), plain_out)
            row = {**case, "group": geo and geo[0],
                   "threads": geo and geo[1], "max_abs_err": e,
                   "bound_ms": bound}
            if not args.quick:
                row["ms"] = timed(launch, iters)
            if counts is not None:
                row["launches"] = counts
                for ph, n in counts.items():
                    loss[ph][case["mode"]] = (
                        loss[ph].get(case["mode"], 0.0)
                        + n * max(0.0, row["ms"] - bound))
            print(json.dumps(row), flush=True)
            if e:
                failed.append(row)

    # K3: P, Q with lane mod 8 = 1 P = Q, 2 P = -Q, 3 P = (0 : 1 : 0),
    # 4 Q = (0 : 1 : 0)
    if args.loss:
        k3 = {(m, int(b)) for ph in proofs
              for m, bs in launches[ph][0].items() for b in bs}
    else:
        sizes = ([1, 32, 1 << 14] if args.quick
                 else [1 << k for k in range(18)])
        k3 = {(m, n) for m in ("K3 proj add", "K3 proj madd",
                               "K3 proj madd (masked)", "K3 proj double")
              for n in sizes}
    nmax = max(n for _, n in k3)
    lane = torch.arange(nmax, device=dev)[:, None]
    one = mont.broadcast_one(F, (nmax,), device=dev)
    zero = torch.zeros_like(one)
    P = [rand_fe(nmax) for _ in range(3)]
    Q = [rand_fe(nmax) for _ in range(3)]
    Q = [torch.where(lane % 8 == 1, p, q) for p, q in zip(P, Q)]
    Q[0] = torch.where(lane % 8 == 2, P[0], Q[0])
    Q[1] = torch.where(lane % 8 == 2, mont.neg(F, P[1]), Q[1])
    Q[2] = torch.where(lane % 8 == 2, P[2], Q[2])
    for pts, r in ((P, 3), (Q, 4)):
        for c, v in enumerate((zero, one, zero)):
            pts[c] = torch.where(lane % 8 == r, v, pts[c]).contiguous()
    valid = (torch.arange(nmax, device=dev) % 4 != 0).to(torch.int64)
    for name, n in sorted(k3, key=lambda c: (c[1], c[0])):
        Ps, Qs, vs = [x[:n] for x in P], [x[:n] for x in Q], valid[:n]
        op, ins, vm, plain, ncoords, nmuls = {
            "K3 proj add": (
                ek.PROJ_ADD, Ps + Qs, None,
                lambda: ek.proj_add_plain(g1, tuple(Ps), tuple(Qs)), 9, 12),
            "K3 proj madd": (
                ek.PROJ_MADD, Ps + Qs[:2], None,
                lambda: ek.proj_madd_plain(g1, tuple(Ps), tuple(Qs[:2])),
                8, 11),
            "K3 proj madd (masked)": (
                ek.PROJ_MADD_MASKED, Ps + Qs[:2], vs,
                lambda: ek.proj_madd_plain(g1, tuple(Ps), tuple(Qs[:2]),
                                           vs != 0), 8, 11),
            "K3 proj double": (
                ek.PROJ_DOUBLE, Ps, None,
                lambda: ek.proj_double_plain(g1, tuple(Ps)), 6, 8),
        }[name]
        counts = ({ph: launches[ph][0].get(name, {}).get(str(n), 0)
                   for ph in proofs} if args.loss else None)
        run_case({"kernel": "K3", "mode": name, "points": n},
                 lambda: ek.proj_launch(g1, op, ins, vm),
                 lambda g, t: proj_direct(op, ins, vm, g, t),
                 PROJ_GEOMETRIES, plain(), 200 if n <= 1 << 12 else 20,
                 bound_ms(ncoords * n * LIMB_BYTES, nmuls * n), counts)
    del P, Q, lane, one, zero, valid

    # K4, with chip_smoke.py's flags (and the edge patterns under --quick)
    def fold_flags(L, k, pattern):
        step = torch.arange(k, device=dev)[:, None]
        lanes = torch.arange(L, device=dev)[None, :]
        changed = ((step * 7 + lanes) % 5 == 0) & (step > 0)
        valid = (step + lanes) % 11 != 0
        save = changed & ((step + lanes) % 3 == 0)
        if pattern == "all changed":
            changed = torch.ones_like(changed)
        elif pattern == "all invalid":
            valid = torch.zeros_like(valid)
        elif pattern == "save-prefix on step 0":
            save = save | (step == 0)
        flags = (changed.to(torch.int64) | (valid.to(torch.int64) << 1)
                 | (save.to(torch.int64) << 2)).contiguous()
        return flags, changed, valid

    edges = [(160, p) for p in ("all changed", "all invalid",
                                "save-prefix on step 0")]
    if args.loss:
        k4 = sorted({(L, k, proj_q, "smoke") for ph in proofs
                     for proj_q, L, k in launches[ph][1]})
    else:
        k4 = [(L, K, proj_q, p) for L, p in
              ([(160, "smoke"), (2560, "smoke")] if args.quick
               else [(L, "smoke") for L in FOLD_LANES]) + edges
              for proj_q in (False, True)]
    for L, k, proj_q, pattern in k4:
        fl, ch, va = fold_flags(L, k, pattern)
        q = [rand_fe(k, L).permute(2, 0, 1).contiguous()
             for _ in range(3 if proj_q else 2)]
        qk = q if proj_q else [(c[0::2] | (c[1::2] << 16)).contiguous()
                               for c in q]
        nmuls = (12 * int((~ch).sum()) if proj_q
                 else 11 * int((~ch & va).sum()))
        nbytes = (sum(c.numel() for c in qk) + k * L + 3 * 16 * k * L
                  + 6 * 16 * L) * 8
        name = "K4 fold projective" if proj_q else "K4 fold level 0"
        counts = ({ph: launches[ph][1].get((proj_q, L, k), 0)
                   for ph in proofs} if args.loss else None)
        run_case({"kernel": "K4", "mode": name, "L": L, "K": k,
                  "flags": pattern},
                 lambda: ek.fold_launch(g1, qk, fl, k, proj_q),
                 lambda g, t: fold_direct(qk, fl, k, proj_q, g, t),
                 FOLD_GEOMETRIES, ek.fold_plain(g1, tuple(q), fl, k, proj_q),
                 5 if L > 4096 else 20, bound_ms(nbytes, nmuls), counts)
        del q, qk, fl
    if args.loss:
        print(json.dumps({"tree": tree, "loss_ms": loss}), flush=True)
    print(smi("name,power.limit"), flush=True)
    if failed:
        print(f"rcb group sweep: {len(failed)} cases differ",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
