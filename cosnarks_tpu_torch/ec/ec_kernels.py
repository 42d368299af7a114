"""K2–K6: the G1 point kernels on Hopper, and their plain versions.

Each is built for two field widths (`_build.WIDTHS`): sixteen 16-bit
limbs per coordinate, eight 32-bit words inside the kernel (BN254 G1), and
twenty-four limbs, twelve words (BLS12-381 G1); each wrapper launches the
build of its curve's width and counts its launches under (words, op,
curve). All
compute with canonical values at every step, so their output limbs equal
the plain versions' exactly. The field arithmetic they share is
csrc/field.cuh. K2-K6 give each point (fold lane, segment) a group of
threads that runs the formula's field products in layers, one product per
lane, with operands passed through shared-memory slots (csrc/group.cuh):
the Jacobian formulas in csrc/jac_group.cuh and the kernels that include
it, RCB in csrc/rcb_group.cuh.

K2 — complete Jacobian add and double (csrc/jacobian.cu). Replaces
  `_add_call` and `_double_call` of cosnarks_tpu/ec/pallas_ec.py: add-2007-bl
  with the selects of `curve.add` for P=inf, Q=inf, P=Q, P=-Q, and
  dbl-2009-l. An int argument picks the op. The main path launches it on
  one point (or Shamir's three) at a time, from `curve.scalar_mul`'s
  256-step loop, so what bounds it is the latency of the formula's chain of
  field products. Each point has a group of four threads: the block stages
  its coordinates through shared memory with coalesced 16-byte copies, and
  the group runs the formula's products layer by layer, one product per
  lane, passing operands through shared memory between layers (five layers
  for the add's 16 products, three for the double's 7), so the chain is 5
  or 3 products long instead of 16 or 7. The selects are the group's,
  uniform across its lanes.
K3 — RCB complete projective add, mixed add (optional validity mask) and
  double (csrc/proj_op.cu). Replaces `_proj_op_call`. 3b = 9 is the same
  double/add chain as `curve._mul_b3` (negated for Grumpkin's b = -17,
  `_b3`). The main path launches it mostly on
  1-32 points (the Horner combine, the last fold levels), so it is
  latency-bound like K2. Each point has a group of 2-8 threads
  (`proj_geometry`, by batch size); the block stages the coordinates as K2
  does, and the group runs the formula in the layers of `RCB_SCHEDULE`
  (csrc/rcb_group.cuh):
  2, 2 and 3 products deep for the add, the madd and the double instead of
  12, 11 and 8. RCB is complete: identity, P = Q and P = -Q take the same
  layers.
K4 — the MSM bucket fold (csrc/msm_fold.cu). Replaces `_level0_call` in
  both modes: level 0 (affine operands packed two limbs per word, RCB mixed
  add) and the later levels (projective boundary-stream operands, RCB add).
  On the TPU the sequential grid axis carried `run` and `prefix` in VMEM
  scratch; here each fold lane has a group of 2 or 8 threads
  (`fold_geometry`, by lane count) that loops over the K steps with both in its shared-memory
  slots and runs each step's RCB add or madd in the layers of
  `RCB_SCHEDULE`, so a step is 2 products deep. The block copies step
  t + 1's operands and flags into shared memory while step t computes, and
  writes the pre-update running sum to buf[:, t, lane] with neighbouring
  threads on neighbouring words (lanes are contiguous in L).
K5 — complete Jacobian + affine mixed add, optional validity mask
  (csrc/jacobian_madd.cu). Replaces `_madd_call`: madd-2007-bl with the
  selects of `curve.madd` (P=-Q -> inf, P=Q -> double, P=inf -> (x2, y2, 1),
  then the mask). No proving path calls `curve.madd`; its shapes are bucket
  accumulation's, up to 2^20 points a launch. Each point has a group of 2
  or 4 threads (`madd_geometry`, by width and batch size) that runs the 11
  products in the five layers of `MADD_LAYERS` (a chain of 5 instead of
  11), and a P = Q point K2's double (csrc/jac_group.cuh); the block stages
  the coordinates as K2 does, point-major, so a point's slots reuse its
  rows' shared memory.
K6 — the weighted bucket reduction sum_j (j+1) S_j per window
  (csrc/wreduce.cu). Replaces `_wreduce_call` with segmented running sums
  across the card: each window splits into P segments of W / P buckets
  (`wreduce_geometry`), a group of threads per segment walks it with two
  running sums in the layers of `RCB_SCHEDULE`, scales its sums by its
  offset with a double-and-add over the segment index, and a second kernel
  adds a window's P results in a pairwise tree. `wreduce_plain` runs the
  same additions in the same order.

What bounds them on the card: by the roofline, bytes for K2-K5, operations
for K6 (the sum needs 2 (W - 1) adds per window over W points read; the
segments, scale and tree do 1.2-1.27x that at the table's splits,
`wreduce_work`). At the int64 limb boundary a coordinate
is 128 bytes (192 at twelve words), and moving a point op's 5-9
coordinates (K2, K3, K5) or a fold step's operands and dumped sum (K4)
takes the card longer than their 8-16 field products of 264 32-bit
multiplies each (588 at twelve words). In practice they run far
above their bounds (PERF.md's kernel table): they are latency- and
occupancy-bound. One thread per point or lane runs the formula's products
as one serial chain and keeps ~30 field elements live (130-184 registers,
nvcc --resource-usage in the smoke output), so few warps per SM hide the
chains; the groups of threads cut the chain to the formula's depth in
layers.

Dispatch: CPU tensors take the plain versions (the formulas of
:mod:`.curve` over :class:`PlainFqOps`); CUDA tensors launch or raise.
Each `*_launch` wrapper counts its launches per width, op and curve in
`.launches[(words, op, curve name)]` (K6, which has one op, per bucket
width W), so that two curves of one width (BN254 G1 and Grumpkin) count
apart, and their batch sizes in `.sizes[(key, bucket)]` (points, fold lanes
L, or windows for K6; see `mont_kernel.count`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ff.mont_kernel import (check_aligned, check_operands, count,
                              field_params, field_words, launch, ptr)
from . import curve
from .ops import PlainFqOps

JAC_ADD, JAC_DOUBLE = 0, 1
PROJ_ADD, PROJ_MADD, PROJ_MADD_MASKED, PROJ_DOUBLE = 0, 1, 2, 3


def _plain_ops(spec):
    return PlainFqOps(spec.ops.field)


def _b3(spec) -> int:
    """3b as the RCB kernels take it (csrc/point.cuh mul_b3), the two cases
    of `curve._mul_b3`'s chain: 3b itself when 0 < 3b <= 64 (BN254 G1 9,
    BLS12-381 G1 12), and -m when 3b = -m mod p with 0 < m <= 64 (Grumpkin,
    b = -17: -51), the chain of m negated. Raises for any other b."""
    b = spec.b
    if isinstance(b, int):
        if 0 < 3 * b <= 64:
            return 3 * b
        p = spec.ops.field.p
        m = p - 3 * b % p
        if m <= 64:
            return -m
    raise ValueError(f"the point kernels take curves whose 3b is a small "
                     f"integer or minus one, not {spec}")


def _key(spec, op: int):
    """A launch counter's key: the build's width, the op and the curve."""
    return field_words(spec.ops.field), op, spec.name


def _flatten(coords, n):
    """Broadcast coordinate tensors to one batch shape and flatten each to a
    contiguous (total, n) tensor."""
    coords = torch.broadcast_tensors(*coords)
    shape = coords[0].shape[:-1]
    return [c.reshape(-1, n).contiguous() for c in coords], shape


def _unflatten(out, shape, n):
    return tuple(o.reshape(shape + (n,)) for o in out)


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_mask(valid, total: int, device):
    if valid is not None and (
            valid.device != device or valid.dtype != torch.int64
            or valid.shape != (total,) or not valid.is_contiguous()):
        raise ValueError("validity mask must be a contiguous int64 "
                         "(total,) tensor on the coordinates' device")


# --------------------------------------------------------------------------
# K2: complete Jacobian add / double
# --------------------------------------------------------------------------

def add_plain(spec, P, Q):
    return curve._add_formula(_plain_ops(spec), P, Q)


def double_plain(spec, P):
    return curve._double_formula(_plain_ops(spec), P)


def jacobian_launch(spec, op: int, coords):
    """Launch K2 on flat contiguous (total, n) coordinate tensors (3 for
    double, 6 for add); returns the 3 output coordinates."""
    n = spec.ops.field.nlimbs
    check_operands(coords, n, coords[0].device)
    check_aligned(coords)
    total = coords[0].shape[0]
    if any(c.shape[0] != total for c in coords):
        raise ValueError("coordinate batch sizes differ")
    if len(coords) != (6 if op == JAC_ADD else 3):
        raise ValueError("the add takes 6 coordinates, the double 3")
    out = [torch.empty_like(coords[0]) for _ in range(3)]
    if total == 0:
        return out
    args = list(coords) + [None] * (6 - len(coords))
    words = field_words(spec.ops.field)
    lib = _build.load("jacobian", words)
    with torch.cuda.device(coords[0].device):
        launch(lib.cosnarks_jacobian, ctypes.c_int(op),
               *[ptr(a) if a is not None else None for a in args],
               *[ptr(o) for o in out], ctypes.c_int64(total),
               field_params(spec.ops.field))
    count(jacobian_launch, _key(spec, op), total)
    return out


jacobian_launch.launches = {}
jacobian_launch.sizes = {}


def add(spec, P, Q):
    n = spec.ops.field.nlimbs
    flat, shape = _flatten(list(P) + list(Q), n)
    if _on_cpu(flat):
        return _unflatten(add_plain(spec, tuple(flat[:3]), tuple(flat[3:])),
                          shape, n)
    return _unflatten(jacobian_launch(spec, JAC_ADD, flat), shape, n)


def double(spec, P):
    n = spec.ops.field.nlimbs
    flat, shape = _flatten(list(P), n)
    if _on_cpu(flat):
        return _unflatten(double_plain(spec, tuple(flat)), shape, n)
    return _unflatten(jacobian_launch(spec, JAC_DOUBLE, flat), shape, n)


# --------------------------------------------------------------------------
# K3 and K4: RCB formulas on groups of threads
# --------------------------------------------------------------------------

# The RCB formulas as csrc/rcb_group.cuh runs them on a group of threads per
# point, for each op its steps in order. A tuple is a layer of independent
# products (name, a, b): product k of the layer is computed by lane k mod G
# as a * b. A dict holds the sums that every lane computes between layers.
# "out" gives the output coordinates (X3, Y3, Z3). Operands, sums and
# outputs are linear combinations "c*name + ...", c an integer or b3 (3b);
# every value is canonical, so the order of the additions does not change a
# limb. The masked madd is the madd with P kept where `valid` is False.
RCB_SCHEDULE = {
    "add": {
        "in": ("X1", "Y1", "Z1", "X2", "Y2", "Z2"),
        "steps": (
            (("t0", "X1", "X2"), ("t1", "Y1", "Y2"), ("t2", "Z1", "Z2"),
             ("s3", "X1 + Y1", "X2 + Y2"), ("s4", "Y1 + Z1", "Y2 + Z2"),
             ("s5", "X1 + Z1", "X2 + Z2")),
            {"t3": "s3 - t0 - t1", "t4": "s4 - t1 - t2",
             "y": "b3*s5 - b3*t0 - b3*t2", "t0'": "3*t0",
             "z": "t1 + b3*t2", "t1'": "t1 - b3*t2"},
            (("A", "t4", "y"), ("B", "t3", "t1'"), ("C", "y", "t0'"),
             ("D", "t1'", "z"), ("E", "t0'", "t3"), ("F", "z", "t4")),
        ),
        "out": ("B - A", "D + C", "F + E"),
    },
    "madd": {
        "in": ("X1", "Y1", "Z1", "x2", "y2"),
        "steps": (
            (("t0", "X1", "x2"), ("t1", "Y1", "y2"),
             ("s3", "X1 + Y1", "x2 + y2"), ("u", "Z1", "x2"),
             ("v", "Z1", "y2")),
            {"t3": "s3 - t0 - t1", "t5": "v + Y1", "y": "b3*u + b3*X1",
             "t0'": "3*t0", "z": "t1 + b3*Z1", "t1'": "t1 - b3*Z1"},
            (("A", "t5", "y"), ("B", "t3", "t1'"), ("C", "y", "t0'"),
             ("D", "t1'", "z"), ("E", "t0'", "t3"), ("F", "z", "t5")),
        ),
        "out": ("B - A", "D + C", "F + E"),
    },
    "double": {
        "in": ("X", "Y", "Z"),
        "steps": (
            (("t0", "Y", "Y"), ("t1", "Y", "Z"), ("t2", "Z", "Z"),
             ("xy", "X", "Y")),
            {"z3": "8*t0", "t2'": "b3*t2"},
            (("x3", "t2'", "z3"), ("Z3", "t1", "z3")),
            {"t0'": "t0 - 3*t2'", "y3": "t0 + t2'"},
            (("Y3", "t0'", "y3"), ("X3", "t0'", "xy")),
        ),
        "out": ("2*X3", "x3 + Y3", "Z3"),
    },
}

# Launch geometry: (threads per point or fold lane, threads per block).
# scripts/torch_rcb_group_sweep.py timed groups of 2, 4 and 8 in blocks of
# 64-256 threads at 1-2^17 points and 160-53248 fold lanes on an H100
# (PERF.md). Up to GROUP_WIDE_MAX items a launch is latency-bound and 8
# threads an item, the shortest chain, was the fastest or within 4 % of it
# (but K3's double at 4096 points, 13 % behind 4); above it the card is
# full and fewer redundant additions per product win: 2 threads an item (4
# for K3's add, the faster of the two for it). K4 is built for groups of 2
# and 8 only, the two this table picks; K3 for 2, 4 and 8.
GROUP_WIDE_MAX = 4096
PROJ_GEOMETRY = {"latency": (8, 64), "add": (4, 128), "other": (2, 64)}
FOLD_GEOMETRY = {"latency": (8, 128), "throughput": (2, 128)}


def proj_geometry(total: int, op: int):
    """(group, threads, blocks) of K3's op over `total` points: a group of
    `group` threads per point, threads // group points per block."""
    group, threads = PROJ_GEOMETRY[
        "latency" if total <= GROUP_WIDE_MAX
        else "add" if op == PROJ_ADD else "other"]
    return group, threads, -(-total // (threads // group))


def fold_geometry(L: int):
    """(group, threads, blocks) of K4 over L fold lanes (either mode)."""
    group, threads = FOLD_GEOMETRY[
        "latency" if L <= GROUP_WIDE_MAX else "throughput"]
    return group, threads, -(-L // (threads // group))


# --------------------------------------------------------------------------
# K3: RCB projective add / mixed add / double
# --------------------------------------------------------------------------

def proj_add_plain(spec, P, Q):
    return curve._proj_add_formula(spec, _plain_ops(spec), P, Q)


def proj_madd_plain(spec, P, Q_affine, valid=None):
    return curve._proj_madd_formula(spec, _plain_ops(spec), P, Q_affine,
                                    valid)


def proj_double_plain(spec, P):
    return curve._proj_double_formula(spec, _plain_ops(spec), P)


def proj_launch(spec, op: int, coords, valid=None):
    """Launch K3 on flat contiguous (total, n) coordinates: 6 for add, 5
    for madd (plus a (total,) int64 validity mask when masked), 3 for
    double; returns the 3 output coordinates."""
    n = spec.ops.field.nlimbs
    device = coords[0].device
    check_operands(coords, n, device)
    check_aligned(coords)
    total = coords[0].shape[0]
    if any(c.shape[0] != total for c in coords):
        raise ValueError("coordinate batch sizes differ")
    if (op == PROJ_MADD_MASKED) != (valid is not None):
        raise ValueError("a validity mask goes with the masked madd only")
    _check_mask(valid, total, device)
    out = [torch.empty_like(coords[0]) for _ in range(3)]
    if total == 0:
        return out
    args = list(coords) + [None] * (6 - len(coords))
    group, threads, blocks = proj_geometry(total, op)
    words = field_words(spec.ops.field)
    lib = _build.load("proj_op", words)
    with torch.cuda.device(device):
        launch(lib.cosnarks_proj_op, ctypes.c_int(op),
               *[ptr(a) if a is not None else None for a in args],
               ptr(valid) if valid is not None else None,
               *[ptr(o) for o in out], ctypes.c_int64(total),
               ctypes.c_int(_b3(spec)), ctypes.c_int(group),
               ctypes.c_int(threads), ctypes.c_int(blocks),
               field_params(spec.ops.field))
    count(proj_launch, _key(spec, op), total)
    return out


proj_launch.launches = {}
proj_launch.sizes = {}


def proj_add(spec, P, Q):
    n = spec.ops.field.nlimbs
    flat, shape = _flatten(list(P) + list(Q), n)
    if _on_cpu(flat):
        return _unflatten(
            proj_add_plain(spec, tuple(flat[:3]), tuple(flat[3:])), shape, n)
    return _unflatten(proj_launch(spec, PROJ_ADD, flat), shape, n)


def proj_madd(spec, P, Q_affine, valid=None):
    n = spec.ops.field.nlimbs
    flat, shape = _flatten(list(P) + list(Q_affine), n)
    vflat = None
    if valid is not None:
        vflat = valid.expand(shape).reshape(-1)
    if _on_cpu(flat):
        return _unflatten(
            proj_madd_plain(spec, tuple(flat[:3]), tuple(flat[3:]), vflat),
            shape, n)
    if vflat is None:
        return _unflatten(proj_launch(spec, PROJ_MADD, flat), shape, n)
    return _unflatten(
        proj_launch(spec, PROJ_MADD_MASKED, flat,
                    vflat.to(torch.int64).contiguous()), shape, n)


def proj_double(spec, P):
    n = spec.ops.field.nlimbs
    flat, shape = _flatten(list(P), n)
    if _on_cpu(flat):
        return _unflatten(proj_double_plain(spec, tuple(flat)), shape, n)
    return _unflatten(proj_launch(spec, PROJ_DOUBLE, flat), shape, n)


# --------------------------------------------------------------------------
# K4: the MSM bucket fold
# --------------------------------------------------------------------------

def _unpack2(words, n):
    """(n/2, K, L) words holding limbs 2i (low half) and 2i+1 -> (n, K, L)."""
    lo = words & 0xFFFF
    hi = words >> 16
    return torch.stack([lo, hi], dim=1).reshape((n,) + words.shape[1:])


def fold_plain(spec, q, flags, K: int, proj_q: bool):
    """Plain version of the fold: q is the tuple of (n, K, L) limb-major
    operand coordinates (2 affine or 3 projective, unpacked)."""
    o = _plain_ops(spec)
    n = spec.ops.field.nlimbs
    L = flags.shape[1]
    dev = flags.device
    zero = torch.zeros((L, n), dtype=torch.int64, device=dev)
    one = o.one_like(zero).expand(L, n)
    run = (zero, one, zero)
    pre = (zero, one, zero)
    bufs = [torch.empty((n, K, L), dtype=torch.int64, device=dev)
            for _ in range(3)]
    for t in range(K):
        fl = flags[t]
        changed = (fl & 1) != 0
        valid = (fl & 2) != 0
        save_prefix = (fl & 4) != 0
        Q = tuple(c[:, t, :].T for c in q)  # (L, n) batch-last
        pre = curve._select(o, save_prefix, run, pre)
        for b, c in zip(bufs, run):
            b[:, t, :] = c.T
        if proj_q:
            addend = curve._select(o, ~changed & valid, Q, (zero, one, zero))
            grown = curve._proj_add_formula(spec, o, run, addend)
            v_pt = Q
        else:
            grown = curve._proj_madd_formula(spec, o, run, Q,
                                             ~changed & valid)
            v_pt = (o.select(valid, Q[0], zero), o.select(valid, Q[1], one),
                    o.select(valid, one, zero))
        run = curve._select(o, changed, v_pt, grown)
    run_lm = tuple(c.T.contiguous() for c in run)
    pre_lm = tuple(c.T.contiguous() for c in pre)
    return tuple(bufs), run_lm, pre_lm


def fold_launch(spec, q, flags, K: int, proj_q: bool):
    """Launch K4. q: 2 packed (n/2, K, L) coordinate tensors (level 0) or
    3 unpacked (n, K, L) ones (proj_q); flags (K, L) int64. Besides
    `count`'s buckets, `.shapes[((words, proj_q, curve), L, K)]` counts
    launches by exact shape."""
    n = spec.ops.field.nlimbs
    device = flags.device
    L = flags.shape[1]
    nq = n if proj_q else n // 2
    for c in q:
        check_operands([c], L, device)
        if tuple(c.shape) != (nq, K, L):
            raise ValueError(f"expected operands of shape {(nq, K, L)}, got "
                             f"{tuple(c.shape)}")
    check_operands([flags], L, device)
    if tuple(flags.shape) != (K, L):
        raise ValueError(f"expected flags of shape {(K, L)}")
    if len(q) != (3 if proj_q else 2):
        raise ValueError("level 0 takes x, y; projective levels x, y, z")
    bufs = [torch.empty((n, K, L), dtype=torch.int64, device=device)
            for _ in range(3)]
    lanes = [torch.empty((n, L), dtype=torch.int64, device=device)
             for _ in range(6)]
    if L == 0:
        return tuple(bufs), tuple(lanes[:3]), tuple(lanes[3:])
    qs = list(q) + [None] * (3 - len(q))
    group, threads, blocks = fold_geometry(L)
    words = field_words(spec.ops.field)
    lib = _build.load("msm_fold", words)
    with torch.cuda.device(device):
        launch(lib.cosnarks_msm_fold, ctypes.c_int(int(proj_q)),
               *[ptr(a) if a is not None else None for a in qs], ptr(flags),
               *[ptr(b) for b in bufs], *[ptr(x) for x in lanes],
               ctypes.c_int64(K), ctypes.c_int64(L),
               ctypes.c_int(_b3(spec)), ctypes.c_int(group),
               ctypes.c_int(threads), ctypes.c_int(blocks),
               field_params(spec.ops.field))
    count(fold_launch, _key(spec, int(proj_q)), L, shape=(L, K))
    return tuple(bufs), tuple(lanes[:3]), tuple(lanes[3:])


fold_launch.launches = {}
fold_launch.sizes = {}
fold_launch.shapes = {}


def level0_fold(spec, qx, qy, flags, K: int):
    """The level-0 fold (cosnarks_tpu pallas_ec.level0_fold's signature
    and layout). qx, qy: (n/2, K, L) step-major limb-major point coords,
    two 16-bit limbs per word (limb 2i low), sign already applied; flags
    (K, L): bit0 changed, bit1 valid, bit2 save-prefix. Returns (buf
    (n, K, L) x3, run (n, L) x3, prefix (n, L) x3)."""
    n = spec.ops.field.nlimbs
    if _on_cpu((qx, qy, flags)):
        return fold_plain(spec, (_unpack2(qx, n), _unpack2(qy, n)), flags,
                          K, proj_q=False)
    return fold_launch(spec, (qx, qy), flags, K, proj_q=False)


def proj_fold(spec, qx, qy, qz, flags, K: int):
    """The later-level fold over projective boundary-stream values
    (pallas_ec.proj_fold's signature): qx, qy, qz (n, K, L)."""
    if _on_cpu((qx, qy, qz, flags)):
        return fold_plain(spec, (qx, qy, qz), flags, K, proj_q=True)
    return fold_launch(spec, (qx, qy, qz), flags, K, proj_q=True)


# --------------------------------------------------------------------------
# K5: complete Jacobian + affine mixed add
# --------------------------------------------------------------------------

MADD, MADD_MASKED = 0, 1

# curve.madd as csrc/jacobian_madd.cu runs it on a group of threads per
# point, in RCB_SCHEDULE's notation: "madd" is madd-2007-bl in five layers
# of products, "double" dbl-2009-l in three (csrc/jac_group.cuh), which a
# P = Q point runs instead after the third layer of "madd" (on P's X1, Y1,
# Z1 as X, Y, Z). The selects are the kernel's and curve.madd's: P = inf
# gives (x2, y2, 1) before any layer; H = 0 and rhalf = 0 (P = Q) the
# double; H = 0 alone (P = -Q) Z3 = 0; an invalid point P.
MADD_LAYERS = {
    "madd": {
        "in": ("X1", "Y1", "Z1", "x2", "y2"),
        "steps": (
            (("Z1Z1", "Z1", "Z1"),),
            (("U2", "x2", "Z1Z1"), ("Z1c", "Z1", "Z1Z1")),
            {"H": "U2 - X1"},
            (("S2", "y2", "Z1c"), ("HH", "H", "H"),
             ("ZH", "Z1 + H", "Z1 + H")),
            {"rhalf": "S2 - Y1", "r": "2*rhalf", "I": "4*HH"},
            (("J", "H", "I"), ("V", "X1", "I"), ("r2", "r", "r")),
            {"X3": "r2 - J - 2*V", "VX": "V - X3"},
            (("rVX", "r", "VX"), ("Y1J", "Y1", "J")),
        ),
        "out": ("X3", "rVX - 2*Y1J", "ZH - Z1Z1 - HH"),
    },
    "double": {
        "in": ("X", "Y", "Z"),
        "steps": (
            (("A", "X", "X"), ("B", "Y", "Y"), ("YZ", "Y", "Z")),
            {"E": "3*A"},
            (("C", "B", "B"), ("T", "X + B", "X + B"), ("F", "E", "E")),
            {"D": "2*T - 2*A - 2*C", "X3": "F - 2*D", "DX": "D - X3"},
            (("EDX", "E", "DX"),),
        ),
        "out": ("X3", "EDX - 8*C", "2*YZ"),
    },
}

# Launch geometry of K5 by field width: (threads per point, threads per
# block) up to GROUP_WIDE_MAX points ("latency") and above ("throughput").
# scripts/torch_k5_sweep.py timed groups of 1, 2 and 4 in blocks of 64-256
# at 1, 32, 2^14, 2^17 and 2^20 points, masked and not, on an H100
# (PERF.md): 4 threads a point, the shortest chain, won at 1 and 32 points
# at both widths (the block size within 4 %); above, 2 won at 8 words (2 x
# 128 fastest at 2^17 and 2^20, within 4 % of 2 x 64 at 2^14 unmasked) and 4
# at 12 (4 x 128 fastest at 2^17 and 2^20, 6 % behind 4 x 256 at 2^14).
# One thread a point, the slots staged the same way, was 2.0x / 1.9x slower
# than the table's choice at 2^20, so the kernel is built for 2 and 4.
MADD_GEOMETRY = {8: {"latency": (4, 64), "throughput": (2, 128)},
                 12: {"latency": (4, 64), "throughput": (4, 128)}}


def madd_geometry(total: int, words: int):
    """(group, threads, blocks) of K5 over `total` points at `words` 32-bit
    words: a group of `group` threads per point, threads // group points
    per block."""
    group, threads = MADD_GEOMETRY[words][
        "latency" if total <= GROUP_WIDE_MAX else "throughput"]
    return group, threads, -(-total // (threads // group))


def madd_plain(spec, P, Q_affine, valid=None):
    return curve._madd_formula(_plain_ops(spec), P, Q_affine, valid)


def madd_launch(spec, coords, valid=None):
    """Launch K5 on 5 flat contiguous (total, n) coordinates (x1, y1, z1,
    x2, y2), masked when a (total,) int64 validity mask is given; returns
    the 3 output coordinates."""
    n = spec.ops.field.nlimbs
    device = coords[0].device
    if len(coords) != 5:
        raise ValueError("the mixed add takes x1, y1, z1, x2, y2")
    check_operands(coords, n, device)
    check_aligned(coords)
    total = coords[0].shape[0]
    if any(c.shape[0] != total for c in coords):
        raise ValueError("coordinate batch sizes differ")
    _check_mask(valid, total, device)
    out = [torch.empty_like(coords[0]) for _ in range(3)]
    if total == 0:
        return out
    mode = MADD if valid is None else MADD_MASKED
    words = field_words(spec.ops.field)
    group, threads, blocks = madd_geometry(total, words)
    lib = _build.load("jacobian_madd", words)
    with torch.cuda.device(device):
        launch(lib.cosnarks_jacobian_madd, ctypes.c_int(mode),
               *[ptr(a) for a in coords],
               ptr(valid) if valid is not None else None,
               *[ptr(o) for o in out], ctypes.c_int64(total),
               ctypes.c_int(group), ctypes.c_int(threads),
               ctypes.c_int(blocks), field_params(spec.ops.field))
    count(madd_launch, _key(spec, mode), total)
    return out


madd_launch.launches = {}
madd_launch.sizes = {}


def madd(spec, P, Q_affine, valid=None):
    n = spec.ops.field.nlimbs
    flat, shape = _flatten(list(P) + list(Q_affine), n)
    vflat = None
    if valid is not None:
        vflat = valid.expand(shape).reshape(-1)
    if _on_cpu(flat):
        return _unflatten(
            madd_plain(spec, tuple(flat[:3]), tuple(flat[3:]), vflat),
            shape, n)
    if vflat is not None:
        vflat = vflat.to(torch.int64).contiguous()
    return _unflatten(madd_launch(spec, flat, vflat), shape, n)


# --------------------------------------------------------------------------
# K6: weighted bucket reduction
# --------------------------------------------------------------------------

def _check_width(W: int):
    if W < 64 or W & (W - 1):
        raise ValueError(f"bucket width must be a power of two >= 64, "
                         f"not {W}")


# Launch geometry of K6 by field width and bucket width W: (P segments a
# window, threads a segment, threads a block of the segment kernel).
# scripts/torch_k6_sweep.py timed P = 64-1024 with groups of 2, 4 and 8 in
# blocks of 64-256 threads at both widths on 20 x 4096, 17 x 16384 and
# 16 x 32768 buckets on an H100 (PERF.md); each entry is the fastest there,
# at 17 x 16384 among the splits that do at most 1.3x the 2 (W - 1) adds
# the sum needs (P <= 512; P = 1024 was 7 % faster at 8 words, with 1.5x
# the adds). Segments of 32 buckets (64 at 16 x 32768, 8 words) won; a
# width missing here takes P = min(W / 32, 512).
WREDUCE_GEOMETRY = {
    8: {4096: (128, 8, 256), 16384: (512, 4, 128), 32768: (512, 4, 256)},
    12: {4096: (128, 8, 128), 16384: (512, 2, 128), 32768: (1024, 2, 256)},
}


def wreduce_geometry(W: int, words: int):
    """(P, group, threads) of K6 over windows of W buckets at `words`
    32-bit words: P segments of W / P buckets, a group of `group` threads
    a segment, threads // group segments a block."""
    _check_width(W)
    return WREDUCE_GEOMETRY[words].get(W, (min(W // 32, 512), 4, 128))


def wreduce_work(W: int, P: int):
    """RCB ops a window of the segmented sum at P segments: {"segment_adds":
    2 (W - P), "scale_doublings", "scale_adds", "tree_adds": P - 1}."""
    log_m = (W // P).bit_length() - 1
    return {"segment_adds": 2 * (W - P),
            "scale_doublings": sum(p.bit_length() - 1 + log_m
                                   for p in range(1, P)),
            "scale_adds": sum(bin(p).count("1") for p in range(1, P)),
            "tree_adds": P - 1}


def wreduce_plain(spec, buckets, segments: int | None = None):
    """Plain version of K6, in the kernel's order of additions (so limb for
    limb equal): buckets 3 x (nwin, W, n) -> 3 x (nwin, n). Split into
    `segments` (P, default the geometry's) of m = W / P buckets: per
    segment the running sums run += S_j, acc += run from the top bucket
    down (T_p, A_p), then D_p = (p m) T_p + A_p by double-and-add over p's
    bits (a mask keeps a segment's value where its bits have run out),
    then sum_p D_p pairwise."""
    o = _plain_ops(spec)
    n = spec.ops.field.nlimbs
    nwin, W = buckets[0].shape[:2]
    P = segments or wreduce_geometry(W, field_words(spec.ops.field))[0]
    m = W // P

    def add(a, b):
        return curve._proj_add_formula(spec, o, a, b)

    def dbl(a):
        return curve._proj_double_formula(spec, o, a)

    s = tuple(x.reshape(nwin, P, m, n) for x in buckets)
    run = acc = tuple(x[:, :, m - 1] for x in s)
    for i in range(m - 2, -1, -1):
        run = add(run, tuple(x[:, :, i] for x in s))
        acc = add(acc, run)
    p = torch.arange(P, device=buckets[0].device)
    r = run
    for bit in range(P.bit_length() - 3, -1, -1):  # below p's top bit
        live = (p >> (bit + 1)) != 0
        r = curve._select(o, live, dbl(r), r)
        r = curve._select(o, live & (((p >> bit) & 1) != 0), add(r, run), r)
    for _ in range(m.bit_length() - 1):
        r = dbl(r)
    d = curve._select(o, p == 0, acc, add(r, acc))
    while d[0].shape[1] > 1:
        d = add(tuple(x[:, 0::2] for x in d), tuple(x[:, 1::2] for x in d))
    return tuple(x[:, 0] for x in d)


def wreduce_launch(spec, buckets):
    """Launch K6 on 3 contiguous (nwin, W, n) bucket coordinates; returns
    3 x (nwin, n)."""
    n = spec.ops.field.nlimbs
    device = buckets[0].device
    check_operands(buckets, n, device)
    check_aligned(buckets)
    nwin, W = buckets[0].shape[:2]
    if any(tuple(b.shape) != (nwin, W, n) for b in buckets):
        raise ValueError(f"expected buckets of shape {(nwin, W, n)}")
    words = field_words(spec.ops.field)
    P, group, threads = wreduce_geometry(W, words)
    out = [torch.empty((nwin, n), dtype=torch.int64, device=device)
           for _ in range(3)]
    if nwin == 0:
        return tuple(out)
    # the segment sums D_p, 3 coordinates of `words` 32-bit words each
    scratch = torch.empty((nwin, P, 3 * words), dtype=torch.int32,
                          device=device)
    lib = _build.load("wreduce", words)
    with torch.cuda.device(device):
        launch(lib.cosnarks_wreduce, *[ptr(b) for b in buckets],
               *[ptr(x) for x in out], ptr(scratch), ctypes.c_int64(nwin),
               ctypes.c_int64(W), ctypes.c_int64(P), ctypes.c_int(_b3(spec)),
               ctypes.c_int(group), ctypes.c_int(threads),
               field_params(spec.ops.field))
    count(wreduce_launch, _key(spec, W), nwin)
    return tuple(out)


wreduce_launch.launches = {}
wreduce_launch.sizes = {}


def weighted_bucket_sum(spec, buckets):
    """sum_j (j+1) * buckets[:, j] per window in one launch
    (pallas_ec.weighted_bucket_sum's signature): buckets 3 x (nwin, W, n),
    W a power of two >= 64; returns 3 x (nwin, n) projective points."""
    flat = tuple(b.contiguous() for b in buckets)
    if _on_cpu(flat):
        return wreduce_plain(spec, flat)
    return wreduce_launch(spec, flat)
