"""K3 and K4 on groups of threads, on the CPU.

`ec_kernels.RCB_SCHEDULE` spells out the layers of field products that
csrc/rcb_group.cuh runs on a group of threads per point; here it is run
with plain ops and held limb for limb against the JAX package's
`curve.proj_add`, `proj_madd` (masked and not) and `proj_double` on seeded
BN254 and BLS12-381 G1 points (the 8- and 12-word builds run the same
schedule) and on Grumpkin points (3b = -51: the kernels' negated chain)
with identity, P = Q and P = -Q lanes. `proj_geometry` /
`fold_geometry` are the launch geometries of csrc/proj_op.cu and
csrc/msm_fold.cu, and must cover every point or fold lane exactly once
with whole groups inside one warp."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curve as jec
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu_torch.ec import curves
from cosnarks_tpu_torch.ec import ec_kernels as ek
from cosnarks_tpu_torch.ec.ops import PlainFqOps
from cosnarks_tpu_torch.ff import mont_kernel
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs

JSPEC, TSPEC = jcurves.BN254_G1, curves.BN254_G1
CURVES = {"bn254": (jcurves.BN254_G1, curves.BN254_G1),
          "bls12_381": (jcurves.BLS12_381_G1, curves.BLS12_381_G1),
          "grumpkin": (jcurves.GRUMPKIN, curves.GRUMPKIN)}
MAX_THREADS = 256  # csrc/proj_op.cu and csrc/msm_fold.cu kMaxThreads
PROJ_GROUPS = (2, 4, 8)  # the group sizes csrc/proj_op.cu is built for
FOLD_GROUPS = (2, 8)  # and csrc/msm_fold.cu
DEPTH = {"add": 2, "madd": 2, "double": 3}  # layers of products
PRODUCTS = {"add": 12, "madd": 11, "double": 8}
TERM = re.compile(r"([+-]?)\s*(?:(\d+|b3)\*)?([A-Za-z_][\w']*)")


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _terms(expr):
    """[(sign, coefficient, name)] of a linear combination."""
    assert re.fullmatch(r"(\s*[+-]?\s*(\d+\*|b3\*)?[A-Za-z_][\w']*)+", expr)
    return [(-1 if s == "-" else 1, c, name)
            for s, c, name in TERM.findall(expr)]


def _names(expr):
    return {name for _, _, name in _terms(expr)}


def _times(o, x, c: int):
    """c * x for a small c, by doubling and adding (a negative c: -c * x,
    negated, as csrc/point.cuh's mul_b3 takes Grumpkin's 3b)."""
    if c < 0:
        return o.neg(_times(o, x, -c))
    acc = x
    for bit in bin(c)[3:]:
        acc = o.double(acc)
        if bit == "1":
            acc = o.add(acc, x)
    return acc


def _run_schedule(op, inputs, tspec=TSPEC):
    """The schedule of `op` with plain ops: returns (X3, Y3, Z3)."""
    o = PlainFqOps(tspec.ops.field)
    b3 = ek._b3(tspec)  # the kernels' 3b
    sched = ek.RCB_SCHEDULE[op]
    env = dict(zip(sched["in"], inputs))

    def lin(expr):
        acc = None
        for sign, coef, name in _terms(expr):
            v = _times(o, env[name], b3 if coef == "b3" else int(coef or 1))
            if acc is None:
                acc = v if sign > 0 else o.neg(v)
            else:
                acc = o.add(acc, v) if sign > 0 else o.sub(acc, v)
        return acc

    for step in sched["steps"]:
        if isinstance(step, dict):
            env.update({name: lin(e) for name, e in step.items()})
        else:  # one layer: every operand is read before any product lands
            env.update({name: o.mul(lin(a), lin(b))
                        for name, a, b in step})
    return tuple(lin(e) for e in sched["out"])


@pytest.mark.parametrize("op", sorted(ek.RCB_SCHEDULE))
def test_schedule_layers_are_independent(op):
    """Each layer's products read only values defined before the layer, fit
    a group of eight, and the layers count what rcb_group.cuh says."""
    sched = ek.RCB_SCHEDULE[op]
    known = set(sched["in"])
    layers = []
    for step in sched["steps"]:
        if isinstance(step, dict):
            for name, e in step.items():
                assert _names(e) <= known and name not in known
            known |= set(step)
        else:
            layers.append(len(step))
            assert len(step) <= max(PROJ_GROUPS)
            for name, a, b in step:
                assert _names(a) | _names(b) <= known and name not in known
            known |= {name for name, _, _ in step}
    for e in sched["out"]:
        assert _names(e) <= known
    assert len(layers) == DEPTH[op]
    assert sum(layers) == PRODUCTS[op]


def _points(seed, n, jspec=JSPEC):
    """n affine points [k]G (host ints) from a numpy seed."""
    hc = jhost.host_curve(jspec)
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 1 << 40, size=n, dtype=np.uint64)
    return [hc.affine_ints(hc.mul(hc.generator, int(k))) for k in ks]


def _projective(pts, zs, fq):
    """Affine points (None: the identity (0 : 1 : 0)) scaled by z ->
    (X, Y, Z) Montgomery limb arrays (numpy, uint32)."""
    p = fq.p
    rows = [(0, 1, 0) if pt is None else
            (pt[0] * z % p, pt[1] * z % p, z % p)
            for pt, z in zip(pts, zs)]
    return tuple(ints_to_limbs([fq.to_mont_int(r[c]) for r in rows],
                               fq.nlimbs)
                 for c in range(3))


def _affine(pts, fq):
    return tuple(ints_to_limbs([fq.to_mont_int(pt[c]) for pt in pts],
                               fq.nlimbs)
                 for c in range(2))


def _inputs(op, seed, jspec, fq):
    """The op's inputs on eight lanes, as numpy limb arrays: 0 and 7
    ordinary, 1 P = Q (same coordinates), 2 P = Q (another Z), 3 P = -Q,
    4 P = identity, 5 Q = identity (add), 6 both identities (add);
    the madd's Q is affine on every lane."""
    hc = jhost.host_curve(jspec)
    a = _points(seed, 8, jspec)
    b = _points(seed + 1, 8, jspec)
    rng = np.random.default_rng(seed + 2)
    zp = [int(z) for z in rng.integers(2, 1 << 62, size=8, dtype=np.uint64)]
    zq = [int(z) for z in rng.integers(2, 1 << 62, size=8, dtype=np.uint64)]
    neg = hc.affine_ints(hc.neg(hc.lift_affine(a[3])))
    P = [a[0], a[1], a[2], a[3], None, a[5], None, a[7]]
    Q = [b[0], a[1], a[2], neg, b[4], None, None, b[7]]
    zq[1] = zp[1]
    if op == "double":
        return _projective(P, zp, fq)
    if op == "add":
        return _projective(P, zp, fq) + _projective(Q, zq, fq)
    Q = [q if q is not None else b[i] for i, q in enumerate(Q)]
    return _projective(P, zp, fq) + _affine(Q, fq)


@pytest.mark.parametrize("op,curve", [
    pytest.param(op, curve, id=op if curve == "bn254" else f"{op}-{curve}")
    for curve in ("bn254", "bls12_381", "grumpkin")
    for op in ("add", "madd", "madd masked", "double")])
def test_schedule_matches_jax(op, curve):
    """The schedule, run with plain ops, equals the JAX package's RCB
    formula limb for limb (masked: P kept where valid is False)."""
    jspec, tspec = CURVES[curve]
    base = op.split()[0]
    arrs = _inputs(base, 0x5C4 + len(op), jspec, tspec.ops.field)
    got = _run_schedule(base, [torch.from_numpy(x.astype(np.int64))
                               for x in arrs], tspec)
    j = [jnp.asarray(x) for x in arrs]
    if base == "add":
        ref = jec.proj_add(jspec, tuple(j[:3]), tuple(j[3:]))
    elif base == "double":
        ref = jec.proj_double(jspec, tuple(j))
    else:
        valid = None
        if op == "madd masked":
            valid = np.array([True, False, True, True, False, True, False,
                              True])
            P = got  # the schedule runs the madd; the group keeps P
            got = tuple(torch.where(torch.from_numpy(valid)[:, None], g,
                                    torch.from_numpy(x.astype(np.int64)))
                        for g, x in zip(P, arrs[:3]))
            valid = jnp.asarray(valid)
        ref = jec.proj_madd(jspec, tuple(j[:3]), tuple(j[3:]), valid)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))


def _check_geometry(total, group, threads, blocks, groups):
    """Whole groups inside one warp, blocks of whole warps the kernel takes,
    enough blocks for every item and none without one: with the kernels'
    map (thread j of block b works on item b * (threads // group) +
    j // group), every item gets exactly one group."""
    assert group in groups and 32 % group == 0
    assert threads % 32 == 0 and 0 < threads <= MAX_THREADS
    per_block = threads // group
    assert blocks * per_block >= total > (blocks - 1) * per_block


@pytest.mark.parametrize("op", [ek.PROJ_ADD, ek.PROJ_MADD,
                                ek.PROJ_MADD_MASKED, ek.PROJ_DOUBLE],
                         ids=["add", "madd", "madd_masked", "double"])
@pytest.mark.parametrize("total", [1, 20, 32, 4096, 81920])
def test_proj_geometry_covers_every_point(total, op):
    _check_geometry(total, *ek.proj_geometry(total, op), PROJ_GROUPS)


# the proofs' fold lane counts at domain 2^16 (PERF.md), and the sizes
# around the switch to the throughput geometry
@pytest.mark.parametrize("L", [1, 31, 160, 208, 2560, 3328, 4095,
                               ek.GROUP_WIDE_MAX, ek.GROUP_WIDE_MAX + 1,
                               40960, 53248, 81920])
def test_fold_geometry_covers_every_lane(L):
    _check_geometry(L, *ek.fold_geometry(L), FOLD_GROUPS)


def test_count_files_exact_fold_shapes():
    """`count` with a shape files it beside the size bucket; a CPU fold
    runs the plain version and files nothing."""
    def wrapper():
        pass

    wrapper.launches, wrapper.sizes, wrapper.shapes = {}, {}, {}
    for L in (160, 2560, 2560):
        mont_kernel.count(wrapper, 1, L, shape=(L, 32))
    assert wrapper.shapes == {(1, 160, 32): 1, (1, 2560, 32): 2}
    assert wrapper.sizes == {(1, 256): 1, (1, 4096): 2}
    before = dict(ek.fold_launch.shapes)
    K, L = 2, 3
    q = [torch.zeros((16, K, L), dtype=torch.int64) for _ in range(3)]
    flags = torch.full((K, L), 3, dtype=torch.int64)
    ek.proj_fold(TSPEC, *q, flags, K)
    assert ek.fold_launch.shapes == before
