"""One party's local proving step, and the multi-device dry run.

The collaborative Groth16 prover's device work between two network rounds
is one party's local proving phase: sparse matvecs, the odd-coset shift
transforms (ifft, distribute_powers, fft), half-share products and MSMs
(the reference's local_mul_vec / reshare split, co-groth16:
groth16.rs:119-332). `entry()` returns that step on a synthetic 2^10
domain with its inputs; `dryrun_multichip(n)` runs the step and two MSMs
split over n devices in a `torch.distributed` process group (NCCL on
cards, gloo on the CPU) and checks every result against the host curve.

The inputs are the JAX package's (`_synthetic_inputs`: the same numpy
draws, limbs carried across by `convert.limbs_from_numpy`).
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from . import convert, resolve_device
from .ec import curve as ec
from .ec import msm as msm_mod
from .ec.curves import BN254_G1 as SPEC
from .ec.host import host_curve
from .ff import mont
from .ff.bigint import limbs_to_int
from .ff.spec import BN254_FR as F
from .groth16.witness_map import sparse_matvec
from .poly import ntt


def _synthetic_inputs(field, n_vars, nnz, domain_size, seed=0, device=None):
    """(rows, cols, vals, w, zero share) of a random COO matrix with nnz
    entries over a domain_size x n_vars grid and a witness vector:
    canonical limbs below 2^253, numpy's draws in the JAX package's
    order."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, domain_size, size=nnz).astype(np.uint32)
    cols = rng.integers(0, n_vars, size=nnz).astype(np.uint32)

    def rand_field(shape):
        # limbs < 2^15, top limb < 2^13 -> value < 2^253 < p (canonical)
        limbs = rng.integers(0, 1 << 15, size=shape + (field.nlimbs,))
        limbs[..., -1] &= (1 << 13) - 1
        return convert.limbs_from_numpy(limbs.astype(np.uint32), device)

    vals = rand_field((nnz,))
    w = rand_field((n_vars,))
    zero = mont.zeros(field, (domain_size,), device=device)
    return (convert.limbs_from_numpy(rows, device),
            convert.limbs_from_numpy(cols, device), vals, w, zero)


def _local_step(dom, root, n, n_vars, matvec):
    """The step after the two matvecs: c = a * b, the three odd-coset
    shifts, a * b + zero share - c."""

    def shift(x):
        return dom.fft(dom.distribute_powers(dom.ifft(x), root))

    def step(rows, cols, vals, w, zero_share):
        a = matvec(rows, cols, vals, w)
        b = matvec(cols % n, rows % n_vars, vals, w)
        c = mont.mul(F, a, b)
        a, b, c = shift(a), shift(b), shift(c)
        return mont.sub(F, mont.add(F, mont.mul(F, a, b), zero_share), c)

    return step


def entry(device=None):
    """Returns (step, example_args): one party's Groth16 local phase on a
    synthetic 2^10 domain, on `device` (the card unless the caller asks
    for the CPU). step(w, vals, zero_share) runs two sparse matvecs of
    8 * 2^10 products, a product, three odd-coset shifts and
    a * b + zero share - c."""
    dev = resolve_device(device)
    n = 1 << 10
    dom = ntt.groth16_domain(F, n)
    root = ntt.groth16_shift_root(F, dom)
    rows, cols, vals, w, zero = _synthetic_inputs(F, 4 * n, 8 * n, n,
                                                  device=dev)
    local = _local_step(dom, root, n, 4 * n,
                        lambda r, c, v, x: sparse_matvec(F, r, c, v, x, n))

    def step(w, vals, zero_share):
        return local(rows, cols, vals, w, zero_share)

    return step, (w, vals, zero)


# -- the multi-device dry run -----------------------------------------------

def _device_count(device: torch.device) -> int:
    """Cards for NCCL; on the CPU, a gloo rank a core."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _gather(x: torch.Tensor, world: int) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return parts


def _gather_point(P, world: int) -> list:
    """Every rank's Jacobian point (all-gathered coordinates)."""
    coords = [_gather(x, world) for x in P]
    return [tuple(c[i] for c in coords) for i in range(world)]


def _combine(parts: list):
    acc = parts[0]
    for p in parts[1:]:
        acc = ec.add(SPEC, acc, p)
    return acc


def _host_point(P):
    """A Jacobian point (no batch axis) as host affine ints (None: inf)."""
    return ec.decode_points(SPEC, tuple(x[None] for x in P))[0]


def _dryrun_rank(rank: int, world: int, dev, points_per_rank: int) -> dict:
    """One rank's share of the dry run, inside an initialised process
    group; raises on any mismatch. Returns what it checked."""
    hc = host_curve(SPEC)
    r = F.p
    # -- the local step, its matvecs sharded by nonzeros --------------------
    n = 64
    n_vars = 2 * n
    nnz = 8 * world
    rows, cols, vals, w, zero = _synthetic_inputs(F, n_vars, nnz, n, seed=1,
                                                  device=dev)
    lo, hi = rank * nnz // world, (rank + 1) * nnz // world
    dom = ntt.groth16_domain(F, n)
    root = ntt.groth16_shift_root(F, dom)

    def sharded_matvec(rw, cl, vl, x):
        # each rank's partial sums are reduced field elements; the
        # all-gathered partials are added as field elements
        part = sparse_matvec(F, rw[lo:hi], cl[lo:hi], vl[lo:hi], x, n)
        acc = None
        for p in _gather(part, world):
            acc = p if acc is None else mont.add(F, acc, p)
        return acc

    h = _local_step(dom, root, n, n_vars, sharded_matvec)(
        rows, cols, vals, w, zero)
    want_h = _local_step(dom, root, n, n_vars,
                         lambda rw, cl, vl, x: sparse_matvec(
                             F, rw, cl, vl, x, n))(rows, cols, vals, w, zero)
    if not torch.equal(h, want_h):
        raise AssertionError("sharded local step differs from one device's")

    # -- tree MSM: each rank's scalar_mul and add tree, partials combined ---
    n_pts = 8 * world
    scalars_np = np.random.default_rng(2).integers(
        0, 1 << 16, size=(n_pts, F.nlimbs)).astype(np.uint32)
    k_lo, k_hi = rank * n_pts // world, (rank + 1) * n_pts // world
    pts = ec.encode_points(SPEC, [hc.affine_ints(hc.mul(hc.generator, 3 + i))
                                  for i in range(k_lo, k_hi)], device=dev)
    acc = ec.scalar_mul(SPEC, pts, convert.limbs_from_numpy(
        scalars_np[k_lo:k_hi], dev))
    m = k_hi - k_lo
    while m > 1:
        half = m // 2
        acc = ec.add(SPEC, tuple(x[:half] for x in acc),
                     tuple(x[half:2 * half] for x in acc))
        m = half
    tree = _combine(_gather_point(tuple(x[0] for x in acc), world))
    # the points are multiples of G, so the host oracle is one product
    ks = [limbs_to_int(s) for s in scalars_np]
    want = hc.affine_ints(hc.mul(hc.generator, sum(
        k * (3 + i) for i, k in enumerate(ks)) % r))
    if _host_point(tree) != want:
        raise AssertionError("tree MSM differs from the host curve")

    # -- sharded MSM: msm() over each rank's points, partials combined ------
    n_big = points_per_rank * world
    b_lo, b_hi = rank * points_per_rank, (rank + 1) * points_per_rank
    gen = ec.encode_points(SPEC, [SPEC.generator], device=dev)
    lanes = tuple(x.expand((b_hi - b_lo,) + x.shape[1:]).contiguous()
                  for x in gen)
    base = ec.to_affine(SPEC, ec.scalar_mul(SPEC, lanes, mont.encode(
        F, [3 + i for i in range(b_lo, b_hi)], mont=False, device=dev)))
    sc_int = [(7 + 31 * i) % r for i in range(n_big)]
    part = msm_mod.msm(SPEC, base, mont.encode(F, sc_int[b_lo:b_hi],
                                               mont=False, device=dev))
    big = _combine(_gather_point(part, world))
    want2 = hc.affine_ints(hc.mul(hc.generator, sum(
        k * (3 + i) for i, k in enumerate(sc_int)) % r))
    if _host_point(big) != want2:
        raise AssertionError("sharded msm() differs from the host curve")
    return {"rank": rank, "world": world, "device": str(dev),
            "nonzeros": nnz, "tree_points": n_pts, "msm_points": n_big,
            "tree_msm": want, "sharded_msm": want2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(rank, world, device_type, port, points_per_rank, timeout_s,
              results):
    """A rank's process group around `_dryrun_rank`; its summary (or its
    error) goes to `results`."""
    dev = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif world > 1:
        torch.set_num_threads(1)  # a rank a core
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        results.put(_dryrun_rank(rank, world, dev, points_per_rank))
    except Exception as e:  # noqa: BLE001 - reported to the caller
        results.put({"rank": rank, "error": repr(e)})
        raise
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None,
                     points_per_rank: int = 64,
                     timeout_s: float = 300.0) -> list[dict]:
    """Run one party's local step and two MSMs over `n_devices` ranks of
    a `torch.distributed` process group: NCCL with a card a rank, or gloo
    on the CPU. The matvecs are sharded by nonzeros (partial sums
    all-gathered and added as field elements), the tree MSM
    (`scalar_mul` and adds) and `msm()` over `points_per_rank` points a
    rank by points (Jacobian partials all-gathered and added). Every rank
    checks the step against one device's and both MSMs against the host
    curve. One rank runs in this process; more are spawned. Raises with
    fewer devices than `n_devices`, on any mismatch, or when a rank does
    not finish within `timeout_s` (also the process group's timeout).
    Returns each rank's summary."""
    dev = resolve_device(device)
    have = _device_count(dev)
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {have}")
    port = _free_port()
    if n_devices == 1:
        results = queue.Queue()
        _run_rank(0, 1, dev.type, port, points_per_rank, timeout_s, results)
        return [results.get()]
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_run_rank,
                         args=(r, n_devices, dev.type, port,
                               points_per_rank, timeout_s, results),
                         daemon=True)
             for r in range(n_devices)]
    for p in procs:
        p.start()
    try:
        out = []
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"a rank did not finish in {timeout_s} s")
        while not results.empty():
            out.append(results.get())
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [o for o in out if "error" in o]
    if errors or len(out) != n_devices or \
            any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dry run failed: {errors or out}")
    return sorted(out, key=lambda o: o["rank"])
