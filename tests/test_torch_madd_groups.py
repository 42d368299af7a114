"""K5 on groups of threads, on the CPU.

`ec_kernels.MADD_LAYERS` spells out the layers of field products that
csrc/jacobian_madd.cu runs on a group of threads per point: madd-2007-bl in
five layers, and the dbl-2009-l of csrc/jac_group.cuh that a P = Q point
runs instead. Here the table is run with plain ops and the kernel's selects
and held limb for limb against the JAX package's `curve.madd`, masked and
unmasked, on seeded BN254 and BLS12-381 G1 points (the 8- and 12-word
builds run the same layers) with P = inf, P = Q, P = -Q and invalid lanes.
`madd_geometry` is the kernel's launch geometry, and must cover every point
exactly once with whole groups inside one warp, within the shared memory a
block may take."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curve as jec
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu_torch.convert import limbs_from_numpy
from cosnarks_tpu_torch.ec import curves
from cosnarks_tpu_torch.ec import ec_kernels as ek
from cosnarks_tpu_torch.ec.ops import PlainFqOps

CURVES = {"bn254": (jcurves.BN254_G1, curves.BN254_G1),
          "bls12_381": (jcurves.BLS12_381_G1, curves.BLS12_381_G1)}
MAX_THREADS = 256  # csrc/jacobian_madd.cu kMaxThreads
MAX_SMEM = 227 * 1024  # field.cuh kMaxDynamicSmem
GROUPS = (2, 4)  # the group sizes csrc/jacobian_madd.cu is built for
DEPTH = {"madd": 5, "double": 3}  # layers of products
PRODUCTS = {"madd": 11, "double": 7}
TERM = re.compile(r"([+-]?)\s*(?:(\d+)\*)?([A-Za-z_]\w*)")


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
    assert re.fullmatch(r"(\s*[+-]?\s*(\d+\*)?[A-Za-z_]\w*)+", expr)
    return [(-1 if s == "-" else 1, int(c or 1), name)
            for s, c, name in TERM.findall(expr)]


def _names(expr):
    return {name for _, _, name in _terms(expr)}


def _run_layers(op, inputs, o):
    """MADD_LAYERS[op] with plain ops: returns (the outputs, every named
    value)."""
    sched = ek.MADD_LAYERS[op]
    env = dict(zip(sched["in"], inputs))

    def lin(expr):
        acc = None
        for sign, coef, name in _terms(expr):
            v = env[name]
            for _ in range(coef - 1):
                v = o.add(v, env[name])
            if acc is None:
                acc = v if sign > 0 else o.neg(v)
            else:
                acc = o.add(acc, v) if sign > 0 else o.sub(acc, v)
        return acc

    for step in sched["steps"]:
        if isinstance(step, dict):  # in order: a sum may read an earlier one
            for name, e in step.items():
                env[name] = lin(e)
        else:  # one layer: every operand is read before any product lands
            env.update({name: o.mul(lin(a), lin(b)) for name, a, b in step})
    return tuple(lin(e) for e in sched["out"]), env


@pytest.mark.parametrize("op", sorted(ek.MADD_LAYERS))
def test_layers_are_independent(op):
    """Each layer's products read only inputs, earlier layers and the sums
    between layers, fit a group of four in one round, and the layers count
    what csrc/jacobian_madd.cu and csrc/jac_group.cuh say."""
    sched = ek.MADD_LAYERS[op]
    known = set(sched["in"])
    layers = []
    for step in sched["steps"]:
        if isinstance(step, dict):
            for name, e in step.items():
                assert _names(e) <= known and name not in known
                known.add(name)
        else:
            layers.append(len(step))
            assert len(step) <= max(GROUPS)
            for name, a, b in step:
                assert _names(a) | _names(b) <= known and name not in known
            known |= {name for name, _, _ in step}
    for e in sched["out"]:
        assert _names(e) <= known
    assert len(layers) == DEPTH[op]
    assert sum(layers) == PRODUCTS[op]


def _lanes(seed, jspec):
    """Jacobian P = [2]A (Z != 1) and affine Q over eight lanes: ordinary,
    P = inf, P = Q, P = -Q, ordinary, P = inf, P = Q, ordinary; as JAX
    limb arrays."""
    hc = jhost.host_curve(jspec)
    rng = np.random.default_rng(seed)
    ks = rng.integers(1, 1 << 32, size=7, dtype=np.uint64)
    a = [hc.affine_ints(hc.mul(hc.generator, int(k))) for k in ks]
    twice = [hc.affine_ints(hc.double(hc.lift_affine(p))) for p in a]
    minus = hc.affine_ints(hc.neg(hc.lift_affine(twice[2])))
    ps = [a[0], None, a[1], a[2], a[3], None, a[4], a[6]]
    qs = [a[5], a[0], twice[1], minus, a[1], a[2], twice[4], a[3]]
    P = jec.double(jspec, jec.encode_points(jspec, ps))
    Q = jec.encode_points(jspec, qs)[:2]
    return tuple(P), tuple(Q)


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_layers_match_jax(curve, masked):
    """The layers with the kernel's selects equal JAX curve.madd limb for
    limb: P = inf gives (x2, y2, 1), P = Q the double's layers, P = -Q
    Z3 = 0, and (masked) an invalid lane P."""
    jspec, tspec = CURVES[curve]
    o = PlainFqOps(tspec.ops.field)
    jP, jQ = _lanes(0x4D5 + masked, jspec)
    P = tuple(limbs_from_numpy(np.asarray(x)) for x in jP)
    Q = tuple(limbs_from_numpy(np.asarray(x)) for x in jQ)
    valid = np.array([True, True, True, True, False, False, True, False])
    out, env = _run_layers("madd", P + Q, o)
    doubled, _ = _run_layers("double", P, o)
    p_inf = o.is_zero(P[2])
    h_zero, r_zero = o.is_zero(env["H"]), o.is_zero(env["rhalf"])
    out = (out[0], out[1],
           o.select(h_zero & ~r_zero, o.zeros_like(out[2]), out[2]))
    sel = [(h_zero & r_zero, doubled), (p_inf, Q + (o.one_like(P[2]),))]
    if masked:
        sel.append((~torch.from_numpy(valid), P))
    for cond, value in sel:
        out = tuple(o.select(cond, v, x) for v, x in zip(value, out))
    assert bool((h_zero & r_zero & ~p_inf).any())  # a P = Q lane ran
    assert bool((h_zero & ~r_zero & ~p_inf).any())  # and a P = -Q lane
    ref = jec.madd(jspec, jP, jQ, jnp.asarray(valid) if masked else None)
    for g, r in zip(out, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))


@pytest.mark.parametrize("words", [8, 12])
@pytest.mark.parametrize("total", [1, 31, 32, 33, 1 << 14, 1 << 20])
def test_madd_geometry_covers_every_point(total, words):
    """Whole groups inside one warp, blocks of whole warps within the
    kernel's shared memory (5 padded rows and 8 bytes of mask a point),
    enough blocks for every point and none without one: with the kernel's
    map (thread j of block b works on point b * (threads // group) +
    j // group), every point gets exactly one group."""
    group, threads, blocks = ek.madd_geometry(total, words)
    assert group in GROUPS and 32 % group == 0
    assert threads % 32 == 0 and 0 < threads <= MAX_THREADS
    per_block = threads // group
    assert per_block * (5 * (16 * words + 16) + 8) <= MAX_SMEM
    assert blocks * per_block >= total > (blocks - 1) * per_block
