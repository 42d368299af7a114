"""cosnarks_tpu_torch.mpc.shamir and mpc.bridges against cosnarks_tpu's, on
the CPU, three parties with t = 1 over each package's run_parties.

Both packages get the same host RNG seeds (share_values, Rep3 shares) and
the same ShamirState seeds, so their ChaCha draws agree: field shares
compare limb for limb, point shares as affine points."""

import random

import jax
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import curve as jec
from cosnarks_tpu.ec import curves as jcurves
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu.ff import mont as jmont
from cosnarks_tpu.ff.spec import BN254_FR as JFR
from cosnarks_tpu.mpc import bridges as jbridges
from cosnarks_tpu.mpc import rep3 as jrep3
from cosnarks_tpu.mpc import shamir as jshamir
from cosnarks_tpu.mpc.net.local import run_parties as jrun_parties
from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import curves
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.spec import BN254_FR as FR
from cosnarks_tpu_torch.mpc import bridges, rep3, shamir
from cosnarks_tpu_torch.mpc.net.local import run_parties

JG1, G1 = jcurves.BN254_G1, curves.BN254_G1
HC = jhost.host_curve(JG1)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _seed(i, base):
    return bytes([i + base]) * 8


def _values(seed, k):
    rng = random.Random(seed)
    return [rng.randrange(FR.p) for _ in range(k)]


def _same(port, ref) -> bool:
    return np.array_equal(port.numpy(), np.asarray(ref).astype(np.int64))


def _affine_jax(pt):
    return jec.decode_points(JG1, jax.tree.map(lambda x: x[None], pt))[0]


def _affine(pt):
    return ec.decode_points(G1, tuple(x[None] for x in pt))[0]


def test_share_values_and_combine_match_jax():
    vals = _values(1, 6)
    jsh = jshamir.share_values(JFR, vals, 3, 1, random.Random(2))
    tsh = shamir.share_values(FR, vals, 3, 1, random.Random(2))
    assert all(_same(t, j) for t, j in zip(tsh, jsh))
    assert shamir.combine_values(FR, [tsh[0], tsh[2]], [0, 2]) == vals
    assert shamir.combine_values(FR, tsh, [0, 1, 2]) == vals


def test_mul_open_rand_match_jax():
    """mul (local product + king degree reduction), open, and rand with a
    pair buffer small enough that get_pairs refills over the network."""
    xs, ys = _values(3, 5), _values(4, 5)
    jx, jy = (jshamir.share_values(JFR, v, 3, 1, random.Random(5))
              for v in (xs, ys))
    tx, ty = (shamir.share_values(FR, v, 3, 1, random.Random(5))
              for v in (xs, ys))

    def jparty(net):
        st = jshamir.ShamirState.setup(net, JFR, 1, pairs=4,
                                       seed=_seed(net.id, 1))
        prod = jshamir.mul(JFR, jx[net.id], jy[net.id], net, st)
        return prod, jshamir.open(JFR, prod, net, st), jshamir.rand(
            JFR, st, (3,), net=net)

    def party(net):
        st = shamir.ShamirState.setup(net, FR, 1, pairs=4,
                                      seed=_seed(net.id, 1))
        prod = shamir.mul(FR, tx[net.id], ty[net.id], net, st)
        return prod, shamir.open(FR, prod, net, st), shamir.rand(
            FR, st, (3,), net=net)

    ref, got = jrun_parties([jparty] * 3), run_parties([party] * 3)
    for g, r in zip(got, ref):
        assert all(_same(a, b) for a, b in zip(g, r))
        assert mont.decode(FR, g[1]) == [x * y % FR.p for x, y in zip(xs, ys)]
    rands = [g[2] for g in got]
    assert (shamir.combine_values(FR, rands[:2], [0, 1])
            == shamir.combine_values(FR, rands[1:], [1, 2]))


def test_degree_reduce_fork_and_eval_poly_match_jax():
    """degree_reduce of a degree-2 sharing, a forked state's draws, and
    eval_poly at a public point."""
    coeffs = _values(6, 4)
    jc = jshamir.share_values(JFR, coeffs, 3, 1, random.Random(7))
    tc = shamir.share_values(FR, coeffs, 3, 1, random.Random(7))
    x = _values(8, 1)[0]

    def jparty(net):
        st = jshamir.ShamirState.setup(net, JFR, 1, pairs=8,
                                       seed=_seed(net.id, 9))
        sq = jshamir.local_mul(JFR, jc[net.id], jc[net.id])
        red = jshamir.degree_reduce(JFR, sq, net, st)
        child = st.fork()
        ev = jshamir.eval_poly(JFR, list(jc[net.id]),
                               jmont.encode(JFR, [x])[0])
        return red, child._draw(JFR, (2,)), child.r_t, ev

    def party(net):
        st = shamir.ShamirState.setup(net, FR, 1, pairs=8,
                                      seed=_seed(net.id, 9))
        sq = shamir.local_mul(FR, tc[net.id], tc[net.id])
        red = shamir.degree_reduce(FR, sq, net, st)
        child = st.fork()
        ev = shamir.eval_poly(FR, list(tc[net.id]),
                              mont.encode(FR, [x])[0])
        return red, child._draw(FR, (2,)), child.r_t, ev

    ref, got = jrun_parties([jparty] * 3), run_parties([party] * 3)
    for g, r in zip(got, ref):
        assert all(_same(a, b) for a, b in zip(g, r))
    assert (shamir.combine_values(FR, [g[0] for g in got], [0, 1, 2])
            == [c * c % FR.p for c in coeffs])
    want = 0
    for c in reversed(coeffs):
        want = (want * x + c) % FR.p
    assert shamir.combine_values(FR, [g[3] for g in got], [0, 1]) == [want]


def test_open_point_and_degree_reduce_point_match_jax():
    """Point shares [f(alpha_i)]G of a degree-1 sharing: open_point, then a
    degree-2 point sharing reduced by degree_reduce_point and opened."""
    secret = _values(10, 1)[0]
    jsh = jshamir.share_values(JFR, [secret], 3, 1, random.Random(11))
    tsh = shamir.share_values(FR, [secret], 3, 1, random.Random(11))
    want = HC.affine_ints(HC.mul(HC.generator, secret * secret))

    def jparty(net):
        st = jshamir.ShamirState.setup(net, JFR, 1, pairs=8,
                                       seed=_seed(net.id, 12))
        gen = tuple(x[0] for x in jec.encode_points(JG1, [JG1.generator]))
        pt = jshamir._scalar_points(JG1, gen, jsh[net.id][0])
        sq = jshamir._scalar_points(JG1, pt, jsh[net.id][0])  # degree 2
        opened = jshamir.open_point(JG1, pt, net, st)
        red = jshamir.degree_reduce_point(JG1, sq, net, st)
        return (_affine_jax(opened), _affine_jax(red),
                _affine_jax(jshamir.open_point(JG1, red, net, st)))

    def party(net):
        st = shamir.ShamirState.setup(net, FR, 1, pairs=8,
                                      seed=_seed(net.id, 12))
        gen = tuple(x[0] for x in ec.encode_points(G1, [G1.generator]))
        pt = shamir._scalar_points(G1, gen, tsh[net.id][0])
        sq = shamir._scalar_points(G1, pt, tsh[net.id][0])
        opened = shamir.open_point(G1, pt, net, st)
        red = shamir.degree_reduce_point(G1, sq, net, st)
        return (_affine(opened), _affine(red),
                _affine(shamir.open_point(G1, red, net, st)))

    ref, got = jrun_parties([jparty] * 3), run_parties([party] * 3)
    assert got == ref
    for opened, _, reopened in got:
        assert opened == HC.affine_ints(HC.mul(HC.generator, secret))
        assert reopened == want


def test_rep3_to_shamir_bridge_matches_jax():
    vals = _values(13, 4)
    jr3 = jrep3.share_field_elements(JFR, vals, random.Random(14))
    tr3 = rep3.share_field_elements(FR, vals, random.Random(14))

    def jparty(net):
        st = jshamir.ShamirState.setup(net, JFR, 1, pairs=16,
                                       seed=_seed(net.id, 15))
        return jbridges.translate_rep3_to_shamir(JFR, jr3[net.id], net, st)

    def party(net):
        st = shamir.ShamirState.setup(net, FR, 1, pairs=16,
                                      seed=_seed(net.id, 15))
        return bridges.translate_rep3_to_shamir(FR, tr3[net.id], net, st)

    ref, got = jrun_parties([jparty] * 3), run_parties([party] * 3)
    assert all(_same(g, r) for g, r in zip(got, ref))
    assert shamir.combine_values(FR, got[1:], [1, 2]) == vals


def test_rep3_point_to_shamir_bridge_matches_jax():
    """Additive Rep3 point shares of [k]G (made replicated by a reshare)
    translated to degree-1 Shamir point shares; each party's share and the
    opened point agree with the JAX package's as affine points."""
    k, k1, k2 = 123456789, 4242, 777
    p1, p2 = HC.mul(HC.generator, k1), HC.mul(HC.generator, k2)
    p0 = HC.add(HC.mul(HC.generator, k), HC.neg(HC.add(p1, p2)))
    parts = [HC.affine_ints(p) for p in (p0, p1, p2)]

    def jparty(net):
        st = jshamir.ShamirState.setup(net, JFR, 1, pairs=4,
                                       seed=_seed(net.id, 16))
        mine = tuple(x[0] for x in jec.encode_points(JG1, [parts[net.id]]))
        repl = jrep3.point_reshare(JG1, mine, net)
        sh = jbridges.translate_rep3_point_to_shamir(JG1, repl, net, st)
        return _affine_jax(sh), _affine_jax(jshamir.open_point(JG1, sh, net,
                                                               st))

    def party(net):
        st = shamir.ShamirState.setup(net, FR, 1, pairs=4,
                                      seed=_seed(net.id, 16))
        mine = tuple(x[0] for x in ec.encode_points(G1, [parts[net.id]]))
        repl = rep3.point_reshare(G1, mine, net)
        sh = bridges.translate_rep3_point_to_shamir(G1, repl, net, st)
        return _affine(sh), _affine(shamir.open_point(G1, sh, net, st))

    ref, got = jrun_parties([jparty] * 3), run_parties([party] * 3)
    assert got == ref
    assert all(o == HC.affine_ints(HC.mul(HC.generator, k)) for _, o in got)
