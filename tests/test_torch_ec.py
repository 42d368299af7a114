"""cosnarks_tpu_torch.ec (curve ops, the K2/K3/K4 plain versions, MSM)
against cosnarks_tpu.ec and the python-int host oracle, on the CPU.

Point ops compare limb for limb; MSMs compare as affine points (the port
sorts buckets by (bucket, index), where the reference may not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curve as jec
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu.ec import msm as jmsm
from cosnarks_tpu.ec import pallas_ec
from cosnarks_tpu.ff import mont as jmont
from cosnarks_tpu_torch.convert import limbs_from_numpy
from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import curves
from cosnarks_tpu_torch.ec import ec_kernels, msm
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs

G1 = (jcurves.BN254_G1, curves.BN254_G1)
G2 = (jcurves.BN254_G2, curves.BN254_G2)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _small_multiples(spec, seed, n, bits=32):
    """n points [k_i]G with k_i uniform below 2^bits (numpy seed); returns
    (k list, host affine points)."""
    hc = jhost.host_curve(spec)
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << bits, size=n, dtype=np.uint64)]
    return ks, [hc.affine_ints(hc.mul(hc.generator, k)) for k in ks]


def _both(jspec, affine):
    """Host affine points -> (JAX Jacobian arrays, port Jacobian tensors)."""
    jp = jec.encode_points(jspec, affine)
    return jp, tuple(limbs_from_numpy(np.asarray(x)) for x in jp)


def _same(port, ref) -> bool:
    return all(np.array_equal(p.numpy(), np.asarray(r).astype(np.int64))
               for p, r in zip(port, ref))


def _edge_pairs(jspec, seed):
    """(P, Q) lists covering P+inf, inf+Q, inf+inf, P=Q, P=-Q and generic."""
    hc = jhost.host_curve(jspec)
    _, pts = _small_multiples(jspec, seed, 6)
    neg0 = hc.affine_ints(hc.neg(hc.lift_affine(pts[0])))
    ps = [pts[0], None, None, pts[1], pts[0], pts[2], pts[3]]
    qs = [None, pts[1], None, pts[1], neg0, pts[4], pts[5]]
    return ps, qs


@pytest.mark.parametrize("specs", [G1, G2], ids=["g1", "g2"])
def test_jacobian_add_double_match_jax(specs):
    """K2's plain version (G1) and the Fq2 formulas (G2) against curve.add
    and curve.double, edge cases included."""
    jspec, tspec_ = specs
    ps, qs = _edge_pairs(jspec, 11)
    jP, tP = _both(jspec, ps)
    jQ, tQ = _both(jspec, qs)
    assert _same(ec.add(tspec_, tP, tQ),
                 jax.jit(jec.add, static_argnums=0)(jspec, jP, jQ))
    assert _same(ec.double(tspec_, tP),
                 jax.jit(jec.double, static_argnums=0)(jspec, jP))
    if tspec_.ops.coord_ndim == 1:
        assert _same(ec_kernels.add_plain(tspec_, tP, tQ),
                     jec.add(jspec, jP, jQ))


def test_rcb_projective_ops_match_jax():
    """K3's plain version against proj_add, proj_madd (masked and not) and
    proj_double, with identity (0:1:0) operands."""
    jspec, tspec_ = G1
    ps, qs = _edge_pairs(jspec, 12)
    ps = [p if p is not None else (1, 1) for p in ps]
    qs = [q if q is not None else (2, 3) for q in qs]
    jP, tP = _both(jspec, ps)
    jQ, tQ = _both(jspec, qs)
    # projective identity on lane 1 of P and lane 2 of Q
    one = np.asarray(jmont.broadcast_one(jspec.ops.field, (1,)))[0]
    zero = np.zeros_like(one)

    def with_identity(pts, lane):
        x, y, z = (np.asarray(c).copy() for c in pts)
        x[lane], y[lane], z[lane] = zero, one, zero
        return (tuple(jnp.asarray(c) for c in (x, y, z)),
                tuple(limbs_from_numpy(c) for c in (x, y, z)))

    jP, tP = with_identity(jP, 1)
    jQ, tQ = with_identity(jQ, 2)
    assert _same(ec.proj_add(tspec_, tP, tQ), jec.proj_add(jspec, jP, jQ))
    assert _same(ec.proj_double(tspec_, tP), jec.proj_double(jspec, jP))
    assert _same(ec.proj_madd(tspec_, tP, tQ[:2]),
                 jec.proj_madd(jspec, jP, jQ[:2]))
    valid = np.array([True, False, True, True, False, True, True])
    assert _same(
        ec.proj_madd(tspec_, tP, tQ[:2], torch.as_tensor(valid)),
        jec.proj_madd(jspec, jP, jQ[:2], jnp.asarray(valid)))
    assert _same(ec_kernels.proj_add_plain(tspec_, tP, tQ),
                 jec.proj_add(jspec, jP, jQ))


@pytest.mark.parametrize("specs", [G1, G2], ids=["g1", "g2"])
def test_scalar_mul_affine_projective_match_jax(specs):
    jspec, tspec_ = specs
    _, pts = _small_multiples(jspec, 13, 3)
    jP, tP = _both(jspec, pts + [None])
    rng = np.random.default_rng(14)
    r = jspec.scalar_field.p
    scalars = [int.from_bytes(rng.bytes(32), "little") % r
               for _ in range(3)] + [5]
    s = ints_to_limbs(scalars, 16)
    jm = jec.scalar_mul(jspec, jP, jnp.asarray(s))
    tm = ec.scalar_mul(tspec_, tP, limbs_from_numpy(s))
    assert _same(tm, jm)
    assert _same(ec.to_affine(tspec_, tm), jec.to_affine(jspec, jm))
    assert _same(ec.proj_to_jacobian(tspec_, tm),
                 jec.proj_to_jacobian(jspec, jm))
    hc = jhost.host_curve(jspec)
    assert ec.decode_points(tspec_, tm) == [
        hc.affine_ints(hc.mul(hc.lift_affine(p), k))
        for p, k in zip(pts + [None], scalars)]


def _fold_inputs(seed, K, L, proj):
    """Random canonical limb-major operands (n, K, L), and flags mixing
    changed / valid / save-prefix bits, from a numpy seed."""
    rng = np.random.default_rng(seed)
    ncoord = 3 if proj else 2

    def coord():
        x = rng.integers(0, 1 << 16, size=(16, K, L)).astype(np.uint32)
        x[15] &= 0x1FFF  # < 2^253 < p
        return x

    qs = [coord() for _ in range(ncoord)]
    t = np.arange(K)[:, None]
    lane = np.arange(L)[None, :]
    changed = ((t * 7 + lane) % 5 == 0) & (t > 0)
    valid = (t + 3 * lane) % 11 != 0
    save = changed & ((t + lane) % 3 == 0)
    flags = (changed.astype(np.uint32) | (valid.astype(np.uint32) << 1)
             | (save.astype(np.uint32) << 2))
    return qs, flags


@pytest.mark.parametrize("proj", [False, True], ids=["level0", "projective"])
def test_fold_plain_matches_pallas_interpret(proj):
    """K4's plain version against pallas_ec.level0_fold / proj_fold in
    interpret mode at L = 256, K = 32: buf, run and prefix limb for limb."""
    jspec, tspec_ = G1
    K, L = 32, 256
    qs, flags = _fold_inputs(15 + proj, K, L, proj)
    if proj:
        ref = pallas_ec.proj_fold(jspec, *(jnp.asarray(q) for q in qs),
                                  jnp.asarray(flags), K, interpret=True)
        got = ec_kernels.proj_fold(
            tspec_, *(limbs_from_numpy(q) for q in qs),
            limbs_from_numpy(flags), K)
    else:
        packed = [q[0::2] | (q[1::2] << 16) for q in qs]
        ref = pallas_ec.level0_fold(jspec, *(jnp.asarray(q) for q in packed),
                                    jnp.asarray(flags), K, interpret=True)
        got = ec_kernels.level0_fold(
            tspec_, *(limbs_from_numpy(q) for q in packed),
            limbs_from_numpy(flags), K)
    for g, r in zip(got, ref):
        assert _same(g, r)


def _msm_case(specs, n, seed):
    jspec, tspec_ = specs
    ks, pts = _small_multiples(jspec, seed, n)
    rng = np.random.default_rng(seed + 1)
    r = jspec.scalar_field.p
    scalars = [int.from_bytes(rng.bytes(32), "little") % r
               for _ in range(n - 2)] + [0, r - 1]
    hc = jhost.host_curve(jspec)
    expect = hc.affine_ints(
        hc.mul(hc.generator, sum(s * k for s, k in zip(scalars, ks)) % r))
    s = ints_to_limbs(scalars, 16)
    return jspec, tspec_, pts, s, expect


@pytest.mark.parametrize("specs,n,chunk", [(G1, 50, None), (G1, 200, None),
                                           (G1, 1024, None), (G2, 200, None),
                                           (G2, 200, 100)],
                         ids=["g1-50", "g1-200", "g1-1024", "g2-200",
                              "g2-200-chunk100"])
def test_msm_matches_host(specs, n, chunk):
    """msm() against the JAX package's host curve: [sum s_i k_i]G, one
    unchunked scalar multiple. With `chunk`, the path of every 2^20 G2 MSM
    (Pippenger passes of `chunk` points, here two, joined by a complete
    add); g2-200 proves the same points and scalars in one pass. The JAX
    package's device `msm` of 200 G2 points compiles for minutes on the
    CPU, so the host curve stands for it."""
    jspec, tspec_, pts, s, expect = _msm_case(specs, n, 20 + n)
    _, tP = _both(jspec, pts)
    out = msm.msm(tspec_, tP, limbs_from_numpy(s), chunk=chunk)
    assert ec.decode_points(tspec_, tuple(x[None] for x in out))[0] == expect


def test_msm_small_matches_jax():
    jspec, tspec_, pts, s, expect = _msm_case(G1, 50, 70)
    jP, tP = _both(jspec, pts)
    ref = jmsm.msm(jspec, jP, jnp.asarray(s))
    got = msm.msm(tspec_, tP, limbs_from_numpy(s))
    assert _same(got, ref)


def test_signed_digits_and_bucket_bounds_match_jax():
    jspec, tspec_ = G1
    rng = np.random.default_rng(21)
    r = jspec.scalar_field.p
    s = ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % r
                       for _ in range(300)], 16)
    for c in (8, 13, 15):
        jd = jmsm.signed_digits(jspec, jnp.asarray(s), c)
        td = msm.signed_digits(tspec_, limbs_from_numpy(s), c)
        assert np.array_equal(td.numpy(), np.asarray(jd))
    sortedb = np.sort(np.abs(np.asarray(jd)), axis=1).astype(np.int32)
    js, je = jmsm._bucket_bounds(jnp.asarray(sortedb), (1 << 14) + 1)
    ts, te = msm._bucket_bounds(limbs_from_numpy(sortedb), (1 << 14) + 1)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(te.numpy(), np.asarray(je))
