"""cosnarks_tpu_torch on BLS12-381 against cosnarks_tpu, on the CPU: the
host pairing, the kernels' 12-word FieldParams block and the K1-K4 plain
versions at 24 limbs (BLS12-381 Fq / G1). Every comparison is exact:
limbs, Fp12 coefficients, affine points (the fold, through an MSM).
Groth16 over BLS12-381 is tests/test_torch_groth16_bls12_381.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curve as jec
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu.ff import mont as jmont
from cosnarks_tpu.ff import spec as jspec
from cosnarks_tpu.pairing import bls12_381 as jpairing
from cosnarks_tpu_torch.convert import limbs_from_numpy
from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import curves, ec_kernels, msm
from cosnarks_tpu_torch.ff import mont, mont_kernel
from cosnarks_tpu_torch.ff import spec as tspec
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs
from cosnarks_tpu_torch.pairing import bls12_381 as tpairing

G1 = (jcurves.BLS12_381_G1, curves.BLS12_381_G1)
FQ = (jspec.BLS12_381_FQ, tspec.BLS12_381_FQ)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _same(port, ref) -> bool:
    return all(np.array_equal(p.numpy(), np.asarray(r).astype(np.int64))
               for p, r in zip(port, ref))


# --------------------------------------------------------------------------
# the host pairing
# --------------------------------------------------------------------------

def _fp12_ints(f):
    """The twelve Fp coefficients of an Fp12 (either package's classes)."""
    return [fp.v for fp6 in (f.c0, f.c1) for fp2 in (fp6.c0, fp6.c1, fp6.c2)
            for fp in (fp2.c0, fp2.c1)]


def _pair(seed):
    """([a]G1, [b]G2, a, b) as host affine ints, a and b from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    r = jspec.BLS12_381_FR.p
    a, b = (int.from_bytes(rng.bytes(32), "little") % r for _ in range(2))
    h1 = jhost.host_curve(jcurves.BLS12_381_G1)
    h2 = jhost.host_curve(jcurves.BLS12_381_G2)
    return (h1.affine_ints(h1.mul(h1.generator, a)),
            h2.affine_ints(h2.mul(h2.generator, b)), a, b)


@pytest.mark.parametrize("seed", [0xB15, 0xB16])
def test_pairing_matches_jax(seed):
    P, Q, _, _ = _pair(seed)
    got = _fp12_ints(tpairing.pairing(P, Q))
    assert got == _fp12_ints(jpairing.pairing(P, Q))
    assert got != _fp12_ints(tpairing.Fp12.one())


def test_pairing_is_bilinear_and_product_check():
    """e(2P, Q) = e(P, 2Q); e(-2P, Q) e(P, 2Q) = 1 and e(-P, Q) e(P, 2Q)
    is not, in both packages."""
    P, Q, _, _ = _pair(0xB17)
    h1 = jhost.host_curve(jcurves.BLS12_381_G1)
    h2 = jhost.host_curve(jcurves.BLS12_381_G2)
    P2 = h1.affine_ints(h1.double(h1.lift_affine(P)))
    Q2 = h2.affine_ints(h2.double(h2.lift_affine(Q)))
    assert tpairing.pairing(P2, Q) == tpairing.pairing(P, Q2)
    true_pairs = [(tpairing.g1_neg(P2), Q), (P, Q2)]
    false_pairs = [(tpairing.g1_neg(P), Q), (P, Q2)]
    for mod in (tpairing, jpairing):
        assert mod.pairing_product_is_one(true_pairs)
        assert not mod.pairing_product_is_one(false_pairs)


# --------------------------------------------------------------------------
# the 12-word FieldParams block and K1-K4's plain versions at 24 limbs
# --------------------------------------------------------------------------

def _words(x: int, n: int):
    return list(np.frombuffer(x.to_bytes(4 * n, "little"), dtype="<u4"))


@pytest.mark.parametrize("field,nw", [(tspec.BLS12_381_FQ, 12),
                                      (tspec.BN254_FQ, 8)],
                         ids=["bls12_381_fq", "bn254_fq"])
def test_field_params_block(field, nw):
    """p, R mod p (R = 2^(32 nw)) and -p^-1 mod 2^32, word for word."""
    got = list(mont_kernel.field_params(field))
    R = (1 << (32 * nw)) % field.p
    n0inv = (-pow(field.p, -1, 1 << 32)) % (1 << 32)
    assert got == _words(field.p, nw) + _words(R, nw) + [n0inv]
    if nw == 8:  # the BN254 block as the 8-word kernels have always read it
        assert got[0] == 0xD87CFD47 and got[16] == 0xE4866389


def _values(p, seed, n):
    """0, 1, p-1 and n uniform residues, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [0, 1, p - 1] + [int.from_bytes(rng.bytes(56), "little") % p
                            for _ in range(n)]


def test_k1_plain_version_at_24_limbs_matches_jax_mul():
    jf, tf = FQ
    a = ints_to_limbs([tf.to_mont_int(v) for v in _values(tf.p, 1, 125)],
                      24)
    b = ints_to_limbs([tf.to_mont_int(v) for v in _values(tf.p, 2, 125)
                       [::-1]], 24)
    ref = jmont.mul(jf, jnp.asarray(a), jnp.asarray(b))
    ta, tb = limbs_from_numpy(a), limbs_from_numpy(b)
    before = dict(mont_kernel.mul.launches)
    assert _same((mont.mul_plain(tf, ta, tb),), (ref,))
    assert _same((mont_kernel.mul(tf, ta, tb),), (ref,))  # CPU: plain
    assert mont_kernel.mul.launches == before


def _edge_pairs(seed):
    """(P, Q) host affine lists covering P+inf, inf+Q, inf+inf, P=Q, P=-Q
    and ordinary lanes."""
    hc = jhost.host_curve(G1[0])
    rng = np.random.default_rng(seed)
    pts = [hc.affine_ints(hc.mul(hc.generator, int(k)))
           for k in rng.integers(1, 1 << 32, size=6, dtype=np.uint64)]
    neg0 = hc.affine_ints(hc.neg(hc.lift_affine(pts[0])))
    return ([pts[0], None, None, pts[1], pts[0], pts[2], pts[3]],
            [None, pts[1], None, pts[1], neg0, pts[4], pts[5]])


def _both(affine):
    jp = jec.encode_points(G1[0], affine)
    return jp, tuple(limbs_from_numpy(np.asarray(x)) for x in jp)


def test_k2_plain_add_double_match_jax():
    """K2's plain version on BLS12-381 G1 against curve.add / curve.double
    with infinity, P = Q and P = -Q lanes."""
    ps, qs = _edge_pairs(31)
    jP, tP = _both(ps)
    jQ, tQ = _both(qs)
    jspec_, tspec_ = G1
    assert _same(ec_kernels.add_plain(tspec_, tP, tQ),
                 jax.jit(jec.add, static_argnums=0)(jspec_, jP, jQ))
    assert _same(ec_kernels.double_plain(tspec_, tP),
                 jax.jit(jec.double, static_argnums=0)(jspec_, jP))
    assert _same(ec.add(tspec_, tP, tQ), jec.add(jspec_, jP, jQ))


def test_k3_plain_rcb_ops_match_jax():
    """K3's plain versions on BLS12-381 G1 against proj_add, proj_madd
    (masked and not) and proj_double, with identity (0 : 1 : 0) lanes."""
    jspec_, tspec_ = G1
    ps, qs = _edge_pairs(32)
    ps = [p if p is not None else (1, 1) for p in ps]
    qs = [q if q is not None else (2, 3) for q in qs]
    jP, _ = _both(ps)
    jQ, _ = _both(qs)
    one = np.asarray(jmont.broadcast_one(jspec_.ops.field, (1,)))[0]

    def with_identity(pts, lane):
        x, y, z = (np.asarray(c).copy() for c in pts)
        x[lane], y[lane], z[lane] = 0, one, 0
        return (tuple(jnp.asarray(c) for c in (x, y, z)),
                tuple(limbs_from_numpy(c) for c in (x, y, z)))

    jP, tP = with_identity(jP, 1)
    jQ, tQ = with_identity(jQ, 2)
    valid = np.array([True, False, True, True, False, True, True])
    assert _same(ec_kernels.proj_add_plain(tspec_, tP, tQ),
                 jec.proj_add(jspec_, jP, jQ))
    assert _same(ec_kernels.proj_double_plain(tspec_, tP),
                 jec.proj_double(jspec_, jP))
    assert _same(ec_kernels.proj_madd_plain(tspec_, tP, tQ[:2]),
                 jec.proj_madd(jspec_, jP, jQ[:2]))
    assert _same(ec_kernels.proj_madd_plain(tspec_, tP, tQ[:2],
                                            torch.as_tensor(valid)),
                 jec.proj_madd(jspec_, jP, jQ[:2], jnp.asarray(valid)))


def test_k4_fold_plain_at_24_limbs_in_a_2_10_msm_matches_host():
    """K4's plain version on BLS12-381 G1, through a 2^10-point MSM (the
    fewest points at which a projective fold level runs after level 0),
    against the JAX package's host oracle as affine points. (pallas_ec's
    folds in interpret mode take 80-100 s a mode at 24 limbs and the 8-word
    test's L = 256, K = 32 on one CPU core, so this file holds the fold to
    the host oracle.)"""
    jspec_, tspec_ = G1
    hc = jhost.host_curve(jspec_)
    rng = np.random.default_rng(0xF01D)
    n = 1 << 10
    ks = [int(k) for k in rng.integers(1, 1 << 32, size=n, dtype=np.uint64)]
    r = jspec_.scalar_field.p
    scalars = [int.from_bytes(rng.bytes(32), "little") % r
               for _ in range(n - 2)] + [0, r - 1]
    pts = [hc.affine_ints(hc.mul(hc.generator, k)) for k in ks]
    _, tP = _both(pts)
    modes = []
    fold_plain = ec_kernels.fold_plain

    def counted(spec, q, flags, K, proj_q):
        modes.append(proj_q)
        return fold_plain(spec, q, flags, K, proj_q)

    ec_kernels.fold_plain = counted
    try:
        out = msm.msm(tspec_, tP, limbs_from_numpy(ints_to_limbs(scalars,
                                                                 16)))
    finally:
        ec_kernels.fold_plain = fold_plain
    assert set(modes) == {False, True}
    expect = hc.affine_ints(hc.mul(hc.generator,
                                   sum(s * k for s, k in zip(scalars, ks))
                                   % r))
    assert ec.decode_points(tspec_, tuple(x[None] for x in out))[0] == expect
