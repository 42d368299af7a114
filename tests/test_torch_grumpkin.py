"""Grumpkin (y^2 = x^3 - 17 over BN254 Fr) through the port's point kernels'
plain versions, against cosnarks_tpu.ec and the python-int host oracle, on
the CPU.

The CUDA kernels K3, K4 and K6 take 3b as a small signed integer
(`ec_kernels._b3`: -51 for Grumpkin, the negated chain of
`curve._mul_b3`); K2 and K5 use no b. Their plain versions run the same
formulas, so here K2, K3 and K5 compare limb for limb with the JAX
package's curve ops, K4 with `pallas_ec.level0_fold` in interpret mode,
and K6 and `msm()` as affine points with the host. The kernels' field
block must be BN254 Fr's, Grumpkin's base field, not Fq's.
chip_smoke.py holds the kernels to these plain versions on the card."""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curve as jec
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu.ec import pallas_ec
from cosnarks_tpu.ff import mont as jmont
from cosnarks_tpu_torch.convert import limbs_from_numpy
from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import curves, ec_kernels, msm
from cosnarks_tpu_torch.ec.curve import CurveSpec
from cosnarks_tpu_torch.ff import mont_kernel
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs
from cosnarks_tpu_torch.ff.spec import BN254_FQ, BN254_FR

JSPEC, TSPEC = jcurves.GRUMPKIN, curves.GRUMPKIN
HC = jhost.host_curve(JSPEC)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _multiples(seed, n, bits=32):
    """n host affine points [k_i]G, k_i uniform below 2^bits, and the k_i."""
    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 1 << bits, size=n, dtype=np.uint64)]
    return ks, [HC.affine_ints(HC.mul(HC.generator, k)) for k in ks]


def _both(arrays):
    """JAX limb arrays -> (the arrays, the port's tensors)."""
    return (tuple(arrays),
            tuple(limbs_from_numpy(np.asarray(x)) for x in arrays))


def _same(port, ref) -> bool:
    return all(np.array_equal(p.numpy(), np.asarray(r).astype(np.int64))
               for p, r in zip(port, ref))


def _edge_pairs(seed):
    """(P, Q) host points covering P + inf, inf + Q, inf + inf, P = Q,
    P = -Q and generic lanes."""
    _, pts = _multiples(seed, 6)
    neg0 = HC.affine_ints(HC.neg(HC.lift_affine(pts[0])))
    ps = [pts[0], None, None, pts[1], pts[0], pts[2], pts[3]]
    qs = [None, pts[1], None, pts[1], neg0, pts[4], pts[5]]
    return ps, qs


def test_kernels_take_grumpkins_b3_and_refuse_others():
    """3b = -51 goes to the kernels as -51 (the chain of 51, negated); the
    G1 curves keep 9 and 12; a b whose 3b is neither small nor minus a
    small integer, or an Fq2 b, is refused."""
    assert ec_kernels._b3(TSPEC) == -51
    assert ec_kernels._b3(curves.BN254_G1) == 9
    assert ec_kernels._b3(curves.BLS12_381_G1) == 12
    p = BN254_FR.p
    for b in (0, 22, p - 22):  # 3b = 0, 66, -66
        spec = CurveSpec("odd", TSPEC.ops, BN254_FQ, b=b, generator=(1, 2))
        with pytest.raises(ValueError):
            ec_kernels._b3(spec)
    with pytest.raises(ValueError):
        ec_kernels._b3(curves.BN254_G2)


def test_kernel_field_block_is_bn254_fr():
    """The kernels' FieldParams for Grumpkin carry BN254 Fr's p, R mod p and
    -p^-1 mod 2^32, at eight words; BN254 Fq's differ in every part."""
    field = TSPEC.ops.field
    assert field.p == BN254_FR.p and mont_kernel.field_words(field) == 8
    got = list(mont_kernel.field_params(field))
    assert got == list(mont_kernel.field_params(BN254_FR))
    fq = list(mont_kernel.field_params(BN254_FQ))
    assert got[:8] != fq[:8] and got[8:16] != fq[8:16] and got[16] != fq[16]


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4", "K6"])
def test_grumpkin_launches_count_apart_from_bn254(kernel, monkeypatch):
    """Grumpkin and BN254 G1 share the 8-word builds; each launch counts
    under its own curve, (8, op, name), and the RCB kernels (K3, K4, K6)
    are passed that curve's 3b: 9 for BN254 G1, -51 for Grumpkin. The card
    is replaced by a recorder, as in test_torch_launch_sizes."""
    launched = []
    monkeypatch.setattr(ec_kernels._build, "load",
                        lambda name, words=8: types.SimpleNamespace(
                            cosnarks_jacobian="K2", cosnarks_proj_op="K3",
                            cosnarks_msm_fold="K4", cosnarks_wreduce="K6"))
    monkeypatch.setattr(ec_kernels, "launch",
                        lambda fn, *a: launched.append((fn, a)))
    monkeypatch.setattr(ec_kernels, "check_operands", lambda *a: None)
    monkeypatch.setattr(ec_kernels, "check_aligned", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    wrapper, op, b3_arg = {
        "K2": (ec_kernels.jacobian_launch, ec_kernels.JAC_DOUBLE, None),
        "K3": (ec_kernels.proj_launch, ec_kernels.PROJ_DOUBLE, 12),
        "K4": (ec_kernels.fold_launch, 0, 16),
        "K6": (ec_kernels.wreduce_launch, 64, 10)}[kernel]
    for attr in ("launches", "sizes", "shapes"):
        monkeypatch.setattr(wrapper, attr, {}, raising=False)
    for spec in (curves.BN254_G1, TSPEC):
        x = torch.zeros((4, 16), dtype=torch.int64)
        if kernel in ("K2", "K3"):
            wrapper(spec, op, [x] * 3)
        elif kernel == "K4":
            flags = torch.zeros((2, 4), dtype=torch.int64)
            wrapper(spec, [torch.zeros((8, 2, 4), dtype=torch.int64)] * 2,
                    flags, 2, False)
        else:
            wrapper(spec, [torch.zeros((2, 64, 16), dtype=torch.int64)] * 3)
    assert wrapper.launches == {(8, op, "bn254_g1"): 1, (8, op, "grumpkin"): 1}
    assert [fn for fn, _ in launched] == [kernel, kernel]
    if b3_arg is not None:
        assert [a[b3_arg].value for _, a in launched] == [9, -51]


def test_jacobian_ops_match_jax():
    """K2's and K5's plain versions (no b in either) against curve.add,
    curve.double and curve.madd, edge lanes included."""
    ps, qs = _edge_pairs(11)
    jP, tP = _both(jec.encode_points(JSPEC, ps))
    jQ, tQ = _both(jec.encode_points(JSPEC, qs))
    assert _same(ec_kernels.add_plain(TSPEC, tP, tQ),
                 jec.add(JSPEC, jP, jQ))
    assert _same(ec_kernels.double_plain(TSPEC, tP), jec.double(JSPEC, jP))
    qa = [q if q is not None else (1, 1) for q in qs]  # madd takes affine Q
    jA, tA = _both(jec.encode_points(JSPEC, qa)[:2])
    valid = np.array([True, True, False, True, True, False, True])
    assert _same(ec_kernels.madd_plain(TSPEC, tP, tA,
                                       torch.as_tensor(valid)),
                 jec.madd(JSPEC, jP, jA, jnp.asarray(valid)))


def test_rcb_ops_match_jax():
    """K3's plain versions, through the wrappers' CPU dispatch, against
    proj_add, proj_madd (masked and not) and proj_double, with identity
    (0 : 1 : 0) operands: the RCB formulas' 3b multiplications, -51 here."""
    ps, qs = _edge_pairs(12)
    ps = [p if p is not None else HC.affine_ints(HC.generator) for p in ps]
    qs = [q if q is not None else HC.affine_ints(HC.generator) for q in qs]
    jP, tP = _both(jec.encode_points(JSPEC, ps))
    jQ, tQ = _both(jec.encode_points(JSPEC, qs))
    one = np.asarray(jmont.broadcast_one(JSPEC.ops.field, (1,)))[0]

    def with_identity(pts, lane):
        x, y, z = (np.asarray(c).copy() for c in pts)
        x[lane], y[lane], z[lane] = 0, one, 0
        return _both((x, y, z))

    jP, tP = with_identity(jP, 1)
    jQ, tQ = with_identity(jQ, 2)
    assert _same(ec_kernels.proj_add(TSPEC, tP, tQ),
                 jec.proj_add(JSPEC, jP, jQ))
    assert _same(ec_kernels.proj_double(TSPEC, tP),
                 jec.proj_double(JSPEC, jP))
    assert _same(ec_kernels.proj_madd(TSPEC, tP, tQ[:2]),
                 jec.proj_madd(JSPEC, jP, jQ[:2]))
    valid = np.array([True, False, True, True, False, True, True])
    assert _same(ec_kernels.proj_madd(TSPEC, tP, tQ[:2],
                                      torch.as_tensor(valid)),
                 jec.proj_madd(JSPEC, jP, jQ[:2], jnp.asarray(valid)))


def test_level0_fold_plain_matches_pallas_interpret():
    """K4's level-0 plain version (the fold's RCB mixed add) against
    pallas_ec.level0_fold in interpret mode at L = 128 (the least lane count
    it tiles), K = 2 (step 1 holds changed, invalid and save lanes): buf,
    run and prefix limb for limb. The projective levels' RCB add is
    test_rcb_ops_match_jax's."""
    K, L = 2, 128
    rng = np.random.default_rng(17)

    def coord():
        x = rng.integers(0, 1 << 16, size=(16, K, L)).astype(np.uint32)
        x[15] &= 0x1FFF  # < 2^253 < p
        return x

    packed = [q[0::2] | (q[1::2] << 16) for q in (coord(), coord())]
    t, lane = np.arange(K)[:, None], np.arange(L)[None, :]
    changed = ((t * 7 + lane) % 5 == 0) & (t > 0)
    valid = (t + 3 * lane) % 11 != 0
    save = changed & ((t + lane) % 3 == 0)
    flags = (changed.astype(np.uint32) | (valid.astype(np.uint32) << 1)
             | (save.astype(np.uint32) << 2))
    ref = pallas_ec.level0_fold(JSPEC, *(jnp.asarray(q) for q in packed),
                                jnp.asarray(flags), K, interpret=True)
    got = ec_kernels.level0_fold(TSPEC, *(limbs_from_numpy(q) for q in packed),
                                 limbs_from_numpy(flags), K)
    for g, r in zip(got, ref):
        assert _same(g, r)


def test_wreduce_plain_matches_host():
    """K6's plain version at one window of W = 64 projective buckets (Z !=
    1, identity lanes) against the host's sum_j (j+1) S_j."""
    W = 64
    _, pts = _multiples(40, W)
    pts = [None if j % 7 == 3 else p for j, p in enumerate(pts)]
    rng = np.random.default_rng(41)
    zs = [int(z) for z in rng.integers(2, 1 << 62, size=W, dtype=np.uint64)]
    fr = TSPEC.ops.field
    rows = [(0, 1, 0) if p is None else (p[0] * z % fr.p, p[1] * z % fr.p, z)
            for p, z in zip(pts, zs)]
    buckets = tuple(
        limbs_from_numpy(ints_to_limbs([fr.to_mont_int(r[c]) for r in rows],
                                       16)[None])
        for c in range(3))
    got = ec_kernels.wreduce_plain(TSPEC, buckets)
    assert _same(ec_kernels.weighted_bucket_sum(TSPEC, buckets), got)
    expect = None
    for j, p in enumerate(pts):
        if p is not None:
            expect = HC.add(expect, HC.mul(HC.lift_affine(p), j + 1))
    jac = ec.proj_to_jacobian(TSPEC, got)
    assert ec.decode_points(TSPEC, jac) == [HC.affine_ints(expect)]


def test_msm_matches_host():
    """msm() over 64 Grumpkin points (Pippenger through the K4 and K3 plain
    versions) against the host's [sum s_i k_i]G, as affine points."""
    n = 64
    ks, pts = _multiples(20, n)
    r = TSPEC.scalar_field.p
    rng = np.random.default_rng(21)
    scalars = [int.from_bytes(rng.bytes(32), "little") % r
               for _ in range(n - 2)] + [0, r - 1]
    expect = HC.affine_ints(
        HC.mul(HC.generator, sum(s * k for s, k in zip(scalars, ks)) % r))
    _, tP = _both(jec.encode_points(JSPEC, pts))
    out = msm.msm(TSPEC, tP, limbs_from_numpy(ints_to_limbs(scalars, 16)))
    assert ec.decode_points(TSPEC, tuple(x[None] for x in out))[0] == expect
