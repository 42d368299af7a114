"""K5 (complete Jacobian mixed add) and K6 (weighted bucket reduction) plain
versions, curve.add_unsafe and the host-Horner MSM split against
cosnarks_tpu and the python-int host oracle, on the CPU, on BN254 G1 and
(K5, K6) BLS12-381 G1.

curve.madd and add_unsafe compare limb for limb. The K6 plain version runs
the kernel's segmented running sums (the card holds the kernel to it limb
for limb, in chip_smoke.py); the JAX package's `msm._weighted_bucket_sum`
adds in another order, so those compare as affine points. Pallas interpret
mode is not used for `pallas_ec.weighted_bucket_sum`: one nwin = 2, W = 64
case did not finish in minutes on a CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curve as jec
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu.ec import msm as jmsm
from cosnarks_tpu.ff import mont as jmont
from cosnarks_tpu_torch.convert import limbs_from_numpy
from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import curves
from cosnarks_tpu_torch.ec import ec_kernels, msm
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs

JSPEC, TSPEC = jcurves.BN254_G1, curves.BN254_G1
HC = jhost.host_curve(JSPEC)
# (JAX spec, port spec) by curve
SPECS = {"bn254": (JSPEC, TSPEC),
         "bls12_381": (jcurves.BLS12_381_G1, curves.BLS12_381_G1)}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _multiples(seed, n, bits=32, hc=HC):
    """n host affine points [k_i]G, k_i uniform below 2^bits, and the k_i."""
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << bits, size=n, dtype=np.uint64)]
    return ks, [hc.affine_ints(hc.mul(hc.generator, k)) for k in ks]


def _both(arrays):
    """JAX limb arrays -> (the arrays, the port's tensors)."""
    return (tuple(arrays), tuple(limbs_from_numpy(np.asarray(x))
                                 for x in arrays))


def _same(port, ref) -> bool:
    return all(np.array_equal(p.numpy(), np.asarray(r).astype(np.int64))
               for p, r in zip(port, ref))


def _madd_lanes(seed, jspec=JSPEC):
    """Jacobian P = [2]A (Z != 1) and affine Q over the lanes: generic,
    P = inf, P = Q, P = -Q, generic, P = inf and P = Q again."""
    hc = jhost.host_curve(jspec)
    _, a = _multiples(seed, 6, hc=hc)
    twice = [hc.affine_ints(hc.double(hc.lift_affine(p))) for p in a]
    minus = hc.affine_ints(hc.neg(hc.lift_affine(twice[2])))
    ps = [a[0], None, a[1], a[2], a[3], None, a[4]]
    qs = [a[5], a[0], twice[1], minus, a[1], a[2], twice[4]]
    P = jec.double(jspec, jec.encode_points(jspec, ps))
    Q = jec.encode_points(jspec, qs)[:2]
    expect = [hc.affine_ints(hc.add(
        None if p is None else hc.double(hc.lift_affine(p)),
        hc.lift_affine(q))) for p, q in zip(ps, qs)]
    return P, Q, expect


@pytest.mark.parametrize("curve,masked", [
    ("bn254", False), ("bn254", True), ("bls12_381", True)],
    ids=["unmasked", "masked", "bls12_381-masked"])
def test_madd_matches_jax(curve, masked):
    """curve.madd (through the K5 wrapper's plain version) and madd_plain
    against JAX curve.madd, limb for limb, with P = inf, P = Q, P = -Q and
    (masked) invalid lanes that pass P through; on BN254 G1 (16 limbs) and
    BLS12-381 G1 (24 limbs)."""
    jspec, tspec = SPECS[curve]
    jP, jQ, expect = _madd_lanes(31, jspec)
    (jP, tP), (jQ, tQ) = _both(jP), _both(jQ)
    valid = np.array([True, True, False, True, True, False, True])
    jv = jnp.asarray(valid) if masked else None
    tv = torch.as_tensor(valid) if masked else None
    ref = jec.madd(jspec, jP, jQ, jv)
    assert _same(ec.madd(tspec, tP, tQ, tv), ref)
    assert _same(ec_kernels.madd_plain(tspec, tP, tQ, tv), ref)
    got = ec.decode_points(tspec, ec.madd(tspec, tP, tQ, tv))
    kept = ec.decode_points(tspec, tP)
    for i, (g, e) in enumerate(zip(got, expect)):
        assert g == (e if valid[i] or not masked else kept[i])


def test_madd_broadcasts_one_affine_point():
    """A (7,) batch of P plus one affine Q: the port broadcasts Q, equal to
    the reference given Q repeated."""
    jP, jQ, _ = _madd_lanes(32)
    (jP, tP), (jQ, tQ) = _both(jP), _both(jQ)
    ref = jec.madd(JSPEC, jP, tuple(jnp.broadcast_to(x[2], x.shape)
                                    for x in jQ))
    assert _same(ec.madd(TSPEC, tP, tuple(x[2] for x in tQ)), ref)


def test_add_unsafe_matches_jax():
    """curve.add_unsafe against the JAX function, limb for limb, with
    infinity on either side; distinct summands elsewhere."""
    _, a = _multiples(33, 8)
    ps = [a[0], None, None, a[1], a[2]]
    qs = [None, a[3], None, a[4], a[5]]
    jP = jec.double(JSPEC, jec.encode_points(JSPEC, ps))
    jQ = jec.encode_points(JSPEC, qs)
    (jP, tP), (jQ, tQ) = _both(jP), _both(jQ)
    out = ec.add_unsafe(TSPEC, tP, tQ)
    assert _same(out, jec.add_unsafe(JSPEC, jP, jQ))
    assert ec.decode_points(TSPEC, out) == [
        HC.affine_ints(HC.add(None if p is None
                              else HC.double(HC.lift_affine(p)),
                              HC.lift_affine(q)))
        for p, q in zip(ps, qs)]


def _proj_to_affine(X, Y, Z, jspec=JSPEC):
    """Projective (X : Y : Z) limb arrays -> host affine points | None."""
    p = jspec.ops.field.p
    xs, ys, zs = (jmont.decode(jspec.ops.field, jnp.asarray(c))
                  for c in (X, Y, Z))
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, p)
            out.append((x * zi % p, y * zi % p))
    return out


def _buckets(seed, nwin, W, jspec=JSPEC):
    """(nwin, W) projective buckets: [k]G doubled projectively (Z != 1),
    with identity (0 : 1 : 0) lanes; plus the host points."""
    hc = jhost.host_curve(jspec)
    _, a = _multiples(seed, nwin * W, hc=hc)
    pts = [None if j % 7 == 3 else p for j, p in enumerate(a)]
    aff = jec.encode_points(jspec, [p if p is not None else (0, 0)
                                    for p in pts])
    one = jnp.broadcast_to(jmont.broadcast_one(jspec.ops.field, (1,)),
                           aff[0].shape)
    inf = jnp.asarray([p is None for p in pts])[:, None]
    proj = jec.proj_double(jspec, (jnp.where(inf, 0, aff[0]),
                                   jnp.where(inf, one, aff[1]),
                                   jnp.where(inf, 0, one)))
    host_pts = [None if p is None else hc.double(hc.lift_affine(p))
                for p in pts]
    return (tuple(np.asarray(c).reshape(nwin, W, -1) for c in proj),
            host_pts)


@pytest.mark.parametrize("curve,W", [("bn254", 64), ("bn254", 128),
                                     ("bls12_381", 64)],
                         ids=["64", "128", "bls12_381-64"])
def test_wreduce_plain_matches_jax_and_host(curve, W):
    """K6's plain version (and weighted_bucket_sum on the CPU) against
    msm._weighted_bucket_sum and the host's sum_j (j+1) S_j, as affine
    points, at nwin = 2, on BN254 G1 and BLS12-381 G1 (24 limbs)."""
    jspec, tspec = SPECS[curve]
    hc = jhost.host_curve(jspec)
    nwin = 2
    buckets, host_pts = _buckets(40 + W, nwin, W, jspec)
    tb = tuple(limbs_from_numpy(b) for b in buckets)
    got = ec_kernels.wreduce_plain(tspec, tb)
    assert _same(ec_kernels.weighted_bucket_sum(tspec, tb), got)
    ref = jmsm._weighted_bucket_sum(jspec, tuple(jnp.asarray(b)
                                                 for b in buckets))
    expect = []
    for w in range(nwin):
        acc = None
        for j in range(W):
            acc = hc.add(acc, hc.mul(host_pts[w * W + j], j + 1)
                         if host_pts[w * W + j] is not None else None)
        expect.append(hc.affine_ints(acc))
    got_aff = _proj_to_affine(*(g.numpy() for g in got), jspec=jspec)
    assert got_aff == _proj_to_affine(*(np.asarray(r) for r in ref),
                                      jspec=jspec)
    assert got_aff == expect


def test_weighted_bucket_sum_refuses_bad_width():
    b = tuple(torch.zeros((1, 96, 16), dtype=torch.int64) for _ in range(3))
    with pytest.raises(ValueError):
        ec_kernels.weighted_bucket_sum(TSPEC, b)


def test_host_horner_wsums_matches_jax_msm_and_host():
    """_host_horner(_pippenger_wsums(...)) at N = 2^10, c = 8 against the
    JAX package's host oracle: the exact affine point [sum s_i k_i]G (what
    JAX msm.msm returns, without compiling it)."""
    n, c = 1 << 10, 8
    ks, pts = _multiples(50, n)
    rng = np.random.default_rng(51)
    r = JSPEC.scalar_field.p
    scalars = [int.from_bytes(rng.bytes(32), "little") % r
               for _ in range(n - 2)] + [0, r - 1]
    s = ints_to_limbs(scalars, 16)
    _, tP = _both(jec.encode_points(JSPEC, pts))
    wsums = msm._pippenger_wsums(TSPEC, tP, limbs_from_numpy(s), c)
    assert wsums[0].shape == (-(-254 // c), 16)
    out = msm._host_horner(TSPEC, wsums, c)
    got = ec.decode_points(TSPEC, tuple(x[None] for x in out))[0]
    assert got == HC.affine_ints(
        HC.mul(HC.generator, sum(a * k for a, k in zip(scalars, ks)) % r))
