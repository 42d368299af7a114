"""The port's host MPC protocols and gadgets against the JAX package's, on
the CPU: mpc/rep3_scalar.py (HostRng streams, arithmetic, binary and
conversion protocols, comparisons), mpc/yao.py and mpc/yao_circuits.py
(garbled half gates, the plain circuits, a2y / y2b / y2a and the Batcher
sort gadget), mpc/rep3_ring.py and mpc/lut.py (Z_2^k arithmetic and
conversions, one-hot vectors, oblivious LUTs, the radix sort) and
gadgets/ (the Poseidon2 permutation, Merkle trees).

Every protocol runs as three party threads in each package with the same
pairwise keys and the same input shares (drawn from seeds), and every
party's output shares equal the JAX package's share for share; opened
values are also held to a cleartext oracle. The cases mirror
tests/test_rep3_scalar.py, test_yao.py, test_rep3_ring.py and the
Poseidon2 / Merkle part of test_gadgets.py."""

import dataclasses
import random
import secrets
import types

import numpy as np
import pytest

from cosnarks_tpu.gadgets import merkle as jmerkle
from cosnarks_tpu.gadgets import poseidon2 as jposeidon2
from cosnarks_tpu.gadgets import sort as jsort
from cosnarks_tpu.mpc import lut as jlut
from cosnarks_tpu.mpc import rep3_ring as jrr
from cosnarks_tpu.mpc import rep3_scalar as jrs
from cosnarks_tpu.mpc import yao as jyao
from cosnarks_tpu.mpc import yao_circuits as jyc
from cosnarks_tpu.mpc.net import local as jlocal
from cosnarks_tpu.vm import interp as jinterp
from cosnarks_tpu.vm import rep3_driver as jrep3_driver
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.gadgets import merkle, poseidon2, sort
from cosnarks_tpu_torch.mpc import lut, rep3_ring as rr
from cosnarks_tpu_torch.mpc import rep3_scalar as rs
from cosnarks_tpu_torch.mpc import yao, yao_circuits as yc
from cosnarks_tpu_torch.mpc.net import local
from cosnarks_tpu_torch.vm import interp, rep3_driver

P = BN254_FR.p
PORT = types.SimpleNamespace(
    rs=rs, yao=yao, yc=yc, rr=rr, lut=lut, sort=sort, merkle=merkle,
    poseidon2=poseidon2, interp=interp, rep3_driver=rep3_driver,
    run=local.run_parties)
JAX = types.SimpleNamespace(
    rs=jrs, yao=jyao, yc=jyc, rr=jrr, lut=jlut, sort=jsort, merkle=jmerkle,
    poseidon2=jposeidon2, interp=jinterp, rep3_driver=jrep3_driver,
    run=jlocal.run_parties)
KEYS = [bytes([0x37 + j]) * 32 for j in range(3)]


def _flat(x):
    """Shares (either package's dataclasses) and trees of them -> tuples
    and lists of ints."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _flat(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return [int(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    return x


def _split(values, seed, mod=P):
    """Replicated sharings (x_i, x_{i+1}) of `values`, x0 and x1 drawn from
    random.Random(seed): [[(a, b) of party i] for each value]."""
    rnd = random.Random(seed)
    out = []
    for v in values:
        x0, x1 = rnd.randrange(mod), rnd.randrange(mod)
        xs = [x0, x1, (v - x0 - x1) % mod]
        out.append([(xs[i], xs[(i + 1) % 3]) for i in range(3)])
    return out


def _run(fn, values=(), seed=1, k=None):
    """fn(m, proto, shares[, ring]) on three parties in each package, with
    the same keys and input shares; asserts that both packages' results
    are equal share for share and returns the port's."""
    split = _split(values, seed)
    out = []
    for m in (PORT, JAX):
        def party(net, m=m):
            i = net.id
            rng = m.rs.HostRng(KEYS[i], KEYS[(i + 1) % 3])
            pr = m.rs.Rep3Scalar(net, rng, P)
            sh = [m.rs.AShare(*s[i]) for s in split]
            if k is None:
                return fn(m, pr, sh)
            return fn(m, pr, sh, m.rr.Rep3Ring(net, rng, k))
        out.append(m.run([party] * 3))
    res, jres = out
    assert _flat(res) == _flat(jres)
    return res


def _combine(res, idx):
    return rs.Rep3Scalar.combine([r[idx] for r in res], P)


# -- rep3_scalar -------------------------------------------------------------

def test_share_and_rng_streams_match_jax(monkeypatch):
    """Rep3Scalar.share draws from `secrets` in both packages (its `rand`
    argument is unused in both), so one seeded stream gives equal shares;
    HostRng's pair, solo and fork streams are equal."""
    shares = []
    for m in (PORT, JAX):
        rnd = random.Random(5)
        monkeypatch.setattr(secrets, "randbelow", lambda n: rnd.randrange(n))
        shares.append(m.rs.Rep3Scalar.share(1234, P, rand=rnd.randbytes))
    assert _flat(shares[0]) == _flat(shares[1])
    assert rs.Rep3Scalar.combine(shares[0], P) == 1234

    def draws(m):
        rngs = [m.rs.HostRng(KEYS[i], KEYS[(i + 1) % 3]) for i in range(3)]
        out = []
        for r in rngs + [r.fork(3) for r in rngs]:
            out.append((r._km, r._kn, r.pair(), r.zero_xor(254),
                        r.zero_add(P), _flat(r.rand_share(P)),
                        r.solo_mine(P), r.solo_next(P),
                        r.solo_mine_bits(100), r.solo_next_bits(100)))
        return out

    got = draws(PORT)
    assert got == draws(JAX)
    assert sum(g[4] for g in got[:3]) % P == 0  # zero shares
    assert got[0][2][1] == got[1][2][0]  # party 0's next = party 1's own


def _linear_and_mul(m, pr, sh):
    x, y = sh
    return (pr.add(x, y), pr.sub(x, y), pr.mul(x, y), pr.add_public(x, 42),
            pr.mul_public(y, 7), pr.promote(99), pr.neg(x),
            pr.open(x), pr.mul_open_many([x], [y])[0])


def _inv_pow_sqrt_cmux(m, pr, sh):
    x, c, t, f, sq = sh
    return pr.inv(x), pr.pow_public(x, 5), pr.cmux(c, t, f), pr.sqrt(sq)


def _a2b_b2a(m, pr, sh):
    bits = pr.a2b_many(sh)
    return bits, pr.open_bit_many(bits), pr.b2a_many(bits)


def _binary_ops(m, pr, sh):
    bx, by = pr.a2b_many(sh)
    return (pr.open_bit(pr.bxor(bx, by)), pr.open_bit(pr.band(bx, by)),
            pr.open_bit(pr.bor(bx, by)), pr.open_bit(pr.bxor_public(bx, 255)),
            pr.open_bit(pr.band_public(bx, 0xFFFF)),
            pr.binary_add_many([bx], [by], pr.k),
            pr.binary_sub_many([bx], [by], pr.k))


def _bit_inject(m, pr, sh):
    bits = [m.rs.BShare(*(v % 2 for v in (s.a, s.b))) for s in sh]
    return pr.bit_inject_many(bits), pr.open_bit_many(bits)


def _is_zero(m, pr, sh):
    return pr.is_zero_open(sh[0]), pr.is_zero_open(sh[1])


X, Y = 0x1234567890ABCDEF ** 3 % P, 0xFEDCBA ** 5 % P


@pytest.mark.parametrize("case", [
    (_linear_and_mul, [X, Y]),
    (_inv_pow_sqrt_cmux, [X, 1, 17, 23, Y * Y % P]),
    (_a2b_b2a, [0, 1, P - 1, X, Y]),
    (_binary_ops, [X, Y]),
    (_bit_inject, [5, 8, 3]),
    (_is_zero, [0, 17]),
], ids=lambda c: c[0].__name__.strip("_"))
def test_rep3_scalar_protocols_match_jax(case):
    fn, vals = case
    res = _run(fn, vals)
    if fn is _linear_and_mul:
        x, y = vals
        want = [(x + y) % P, (x - y) % P, x * y % P, (x + 42) % P, y * 7 % P,
                99, -x % P]
        assert [_combine(res, i) for i in range(7)] == want
        assert all(r[7] == x and r[8] == x * y % P for r in res)
    elif fn is _inv_pow_sqrt_cmux:
        x, _, t, _, sq = vals
        assert _combine(res, 0) == pow(x, -1, P)
        assert _combine(res, 1) == pow(x, 5, P)
        assert _combine(res, 2) == t
        assert pow(_combine(res, 3), 2, P) == sq
    elif fn is _a2b_b2a:
        assert res[0][1] == vals
        assert [rs.Rep3Scalar.combine([r[2][i] for r in res], P)
                for i in range(len(vals))] == vals
    elif fn is _binary_ops:
        x, y = vals
        assert res[0][:5] == (x ^ y, x & y, x | y, x ^ 255, x & 0xFFFF)
    elif fn is _bit_inject:
        bits = [rs.Rep3Scalar.combine([r[0][i] for r in res], P)
                for i in range(len(vals))]
        assert bits == res[0][1]
    else:
        assert all(r == (True, False) for r in res)


@pytest.mark.parametrize("x,y", [(5, 9), (7, 7), (P - 1, 1), (X, Y)])
def test_rep3_scalar_comparisons_match_jax(x, y):
    def fn(m, pr, sh):
        sx, sy = sh
        return (pr.ge(sx, sy), pr.lt(sx, sy), pr.le(sx, sy), pr.gt(sx, sy),
                pr.eq(sx, sy), pr.neq(sx, sy), pr.ge_public(sx, y),
                pr.le_public(sx, y), pr.lt_public(sx, y),
                pr.gt_public(sx, y))

    res = _run(fn, [x, y], seed=x % 1000)
    want = [x >= y, x < y, x <= y, x > y, x == y, x != y,
            x >= y, x <= y, x < y, x > y]
    assert [_combine(res, i) for i in range(10)] == [int(v) for v in want]


def test_rep3_scalar_fork_matches_jax():
    def fn(m, pr, sh):
        f = pr.fork(2)
        return f.mul(*sh), f.rng.zero_add(P), pr.mul(*sh)

    res = _run(fn, [X, Y])
    assert _combine(res, 0) == _combine(res, 2) == X * Y % P


# -- yao ----------------------------------------------------------------------

def _fake_shared(m, seed):
    rnd = random.Random(seed)
    return m.yao._GarblerShared(lambda s, c: rnd.getrandbits(512))


def test_yao_half_gate_matches_jax():
    """One garbled AND per seed: equal tables and labels in both packages,
    and every input combination decodes to a & b."""
    for seed in (1, 2, 3):
        out = []
        for m in (PORT, JAX):
            g = m.yao.Garbler(_fake_shared(m, seed))
            a0, b0 = g.sh.fresh_label(), g.sh.fresh_label()
            c0 = g.and_(a0, b0)
            out.append((g.circuit_bytes(), g.delta, a0, b0, c0))
        assert out[0] == out[1]
        circuit, d, a0, b0, c0 = out[0]
        for va in (0, 1):
            for vb in (0, 1):
                ev = yao.Evaluator(circuit)
                wc = ev.and_(a0 ^ (d if va else 0), b0 ^ (d if vb else 0))
                assert wc == c0 ^ (d if va & vb else 0)


class _PlainFancy:
    """Constant-only backend: every wire folds, so f is never called."""

    def xor(self, a, b):  # pragma: no cover - all inputs are constants
        raise AssertionError("plain circuit should fully fold")

    and_ = not_ = xor


def test_yao_plain_circuits_match_jax():
    rnd = random.Random(0xFACE)
    nb = P.bit_length()
    pbits = [(P >> i) & 1 for i in range(nb + 2)]
    for _ in range(5):
        xs = [rnd.randrange(P) for _ in range(3)]
        ins = [[bool((x >> i) & 1) for i in range(nb)] for x in xs]
        out = yc.adder_mod_p_3(_PlainFancy(), *ins, pbits)
        assert out == jyc.adder_mod_p_3(_PlainFancy(), *ins, pbits)
        assert sum(1 << i for i, b in enumerate(out) if b is True) \
            == sum(xs) % P
    for n in (1, 3, 8, 13):
        vals = [rnd.randrange(1 << 10) for _ in range(n)]
        sorted_ = []
        for m in (yc, jyc):
            elems = [[bool((v >> i) & 1) for i in range(10)] for v in vals]
            m.batcher_sort_bundles(_PlainFancy(), elems)
            sorted_.append([sum(1 << i for i, b in enumerate(e) if b is True)
                            for e in elems])
        assert sorted_[0] == sorted_[1] == sorted(vals)


def _a2b_yao(m, pr, sh):
    return m.yao.Rep3Yao(pr).a2b_many(sh)


def _b2y_y2b(m, pr, sh):
    e = m.yao.Rep3Yao(pr)
    return e.y2b_many(e.b2y_many(pr.a2b_many(sh)))


def _y2a(m, pr, sh):
    e = m.yao.Rep3Yao(pr)
    return e.y2a_many(e.a2y_many(sh, m.yc.adder_mod_p_3))


def _yao_sort(m, pr, sh):
    return m.sort.batcher_odd_even_merge_sort_yao(pr, sh, 16)


YAO_VALUES = [X, Y, 0, P - 1, 0xBEEF]


@pytest.mark.parametrize("fn", [_a2b_yao, _b2y_y2b, _y2a, _yao_sort],
                         ids=lambda f: f.__name__.strip("_"))
def test_yao_conversions_match_jax(fn):
    res = _run(fn, YAO_VALUES)
    if fn is _y2a:
        got = [_combine(res, i) for i in range(len(YAO_VALUES))]
        assert got == YAO_VALUES
    elif fn is _yao_sort:
        got = [_combine(res, i) for i in range(len(YAO_VALUES))]
        assert got == sorted(v & 0xFFFF for v in YAO_VALUES)
    else:
        for i, v in enumerate(YAO_VALUES):
            sh = [r[i] for r in res]
            assert all(sh[j].b == sh[(j + 1) % 3].a for j in range(3))
            assert sh[0].a ^ sh[1].a ^ sh[2].a == v


# -- rep3_ring and lut --------------------------------------------------------

def _ring_split(m, values, k, seed):
    return [[m.rr.RingShare(*s[i]) for i in range(3)]
            for s in _split(values, seed, 1 << k)]


def test_rep3_ring_arithmetic_and_conversions_match_jax():
    vals = [random.Random(7).getrandbits(32) for _ in range(6)]

    def fn(m, pr, sh, ring):
        xs = [s[ring.id] for s in _ring_split(m, vals, 32, 8)]
        prods = ring.mul_many(xs, xs)
        bs = ring.a2b_many(xs)
        back = ring.b2a_many(bs)
        inj = ring.bit_inject_many(
            [m.rs.BShare((b.a >> 3) & 1, (b.b >> 3) & 1, 1) for b in bs])
        return (prods, bs, back, inj, ring.open_many(prods),
                ring.open_many(back), ring.open_many(inj))

    res = _run(fn, k=32)
    mask = (1 << 32) - 1
    assert res[0][4] == [v * v & mask for v in vals]
    assert res[0][5] == vals
    assert res[0][6] == [(v >> 3) & 1 for v in vals]


def test_rep3_ring_ohv_and_luts_match_jax():
    rnd = random.Random(11)
    table = [rnd.randrange(P) for _ in range(11)]
    idx, new = 7, rnd.randrange(P)
    tbl = _split(table + [new], 12)

    def fn(m, pr, sh, ring):
        i = ring.id
        ohvs = []
        for kk in (1, 2, 4, 6):
            r, e = m.rr.rand_ohv(ring, kk)
            mask = (1 << kk) - 1
            ohvs.append((r, e, ring.open_bits(m.rs.BShare(r.a & mask,
                                                          r.b & mask))))
        ib = ring.a2b_many([_ring_split(m, [idx], 32, 13)[0][i]])[0]
        shared_lut = [m.rs.AShare(*t[i]) for t in tbl[:-1]]
        got_pub = m.rr.read_public_lut(ring, pr, table, ib)
        got_sh = m.rr.read_shared_lut(ring, pr, shared_lut, ib)
        lut2 = m.rr.write_lut(ring, pr, m.rs.AShare(*tbl[-1][i]),
                              shared_lut, ib)
        prov = m.lut.Rep3LookupTableProvider(pr)
        plut = prov.init_public([10, 20, 30, 40])
        two = m.rs.AShare(*_split([2], 14)[0][i])
        r1 = prov.read(two, plut)
        plut2 = prov.write(two, m.rs.AShare(*tbl[-1][i]), plut)
        r2 = prov.read(two, plut2)
        return (ohvs, got_pub, got_sh, lut2, pr.open_many([got_pub, got_sh]),
                pr.open_many(lut2), pr.open_many([r1, r2]))

    res = _run(fn, k=32)
    assert res[0][4] == [table[idx]] * 2
    assert res[0][5] == table[:idx] + [new] + table[idx + 1:]
    assert res[0][6] == [30, new]


@pytest.mark.parametrize("n_priv,n_pub,bits", [(9, 4, 16), (8, 0, 10)])
def test_rep3_ring_radix_sort_matches_jax(n_priv, n_pub, bits):
    """The shuffle masks come from `secrets` (private to a party), so the
    sorted shares differ from run to run in both packages; the opened
    outputs are equal."""
    rnd = random.Random(13 + n_priv)
    priv = [rnd.getrandbits(bits) for _ in range(n_priv)]
    pub = [rnd.getrandbits(bits) for _ in range(n_pub)]
    split = _split(priv, 15)
    opened = []
    for m in (PORT, JAX):
        def party(net, m=m):
            i = net.id
            rng = m.rs.HostRng(KEYS[i], KEYS[(i + 1) % 3])
            pr = m.rs.Rep3Scalar(net, rng, P)
            ring = m.rr.Rep3Ring(net, rng, 32)
            out = m.rr.radix_sort_fields(
                pr, ring, [m.rs.AShare(*s[i]) for s in split], pub, bits)
            return pr.open_many(out)
        opened.append(m.run([party] * 3))
    assert opened[0] == opened[1] == [sorted(priv + pub)] * 3


# -- gadgets ------------------------------------------------------------------

@pytest.mark.parametrize("t", [2, 3, 4, 16])
def test_poseidon2_permutation_matches_jax(t):
    state = [random.Random(t).randrange(P) for _ in range(t)]
    got = poseidon2.Poseidon2(t, P).permutation(interp.PlainDriver(BN254_FR),
                                                state)
    assert got == jposeidon2.Poseidon2(t, P).permutation(
        jinterp.PlainDriver(BN254_FR), state)
    assert got != state and all(0 <= v < P for v in got)


@pytest.mark.parametrize("arity,t,n,idx", [(2, 3, 8, 3), (3, 4, 27, 13)])
def test_merkle_plain_matches_jax(arity, t, n, idx):
    leaves = [random.Random(n).randrange(P) for _ in range(n)]
    out = []
    for m in (PORT, JAX):
        perm = m.poseidon2.Poseidon2(t, P)
        d = m.interp.PlainDriver(BN254_FR)
        root = m.merkle.merkle_root(perm, d, leaves, arity=arity)
        r2, wit = m.merkle.merkle_root_with_witness(perm, d, leaves, idx,
                                                    arity=arity)
        out.append((root, r2, wit, m.merkle.verify_merkle_opening(
            perm, d, leaves[idx], wit, arity=arity),
            m.merkle.verify_merkle_opening(perm, d, (leaves[idx] + 1) % P,
                                           wit, arity=arity)))
    assert out[0] == out[1]
    root, r2, _, opened, tampered = out[0]
    assert root == r2 == opened != tampered


def test_merkle_rep3_matches_jax():
    leaves = [random.Random(0xD00D).randrange(P) for _ in range(8)]
    plain = merkle.merkle_root(poseidon2.Poseidon2(3, P),
                               interp.PlainDriver(BN254_FR), leaves)

    def fn(m, pr, sh):
        drv = m.rep3_driver.Rep3Driver(pr, BN254_FR)
        root = m.merkle.merkle_root(m.poseidon2.Poseidon2(3, P), drv, sh)
        return root, pr.open(drv.to_share(root))

    res = _run(fn, leaves)
    assert [r[1] for r in res] == [plain] * 3
