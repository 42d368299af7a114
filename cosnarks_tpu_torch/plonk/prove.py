"""Collaborative snarkjs-PLONK prover (port of cosnarks_tpu.plonk.prove):
the 5 rounds of https://eprint.iacr.org/2019/953.pdf in the snarkjs
flavor, generic over a PLONK driver (plain / Rep3 / Shamir).

Bit-compatible with snarkjs artifacts: Keccak256 Fiat-Shamir transcript,
snarkjs root-of-unity chain, additions-extended witness, blinding scheme
b1..b11, and the t / tz split that keeps the Z_H division on the unblinded
part. Every independent product of a round is one whole-vector driver
`mul`, so a proof takes about a dozen network rounds.

Where the JAX package scans (`jax.lax.associative_scan`), the port runs a
log-depth doubling scan: log2(k) whole-vector products or sums. Field
arithmetic is exact and canonical, so any association order gives the same
limbs. Public vectors (the zkey's selector, sigma and Lagrange evaluations,
powers of domain elements) go to the device once per proof; powers are
made on the device by doubling, which gives the limbs a host encoding
would.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ec import curves
from ..ff import mont
from ..ff.spec import Field
from ..groth16.prove import _Clock, load_g1_array
from ..io.zkey import PlonkZkey, g1_to_ints
from ..mpc import rep3
from ..mpc.net.base import join
from ..poly.ntt import groth16_domain
from ..utils import timing
from ..utils.keccak import keccak256


# -- transcript ------------------------------------------------------------

class Transcript:
    """snarkjs Keccak256 transcript: BE field elements / affine coords
    (32 bytes for BN254, 48 for BLS12-381 Fq); infinity = 2 x nq zero
    bytes; challenge = digest BE mod r (reference types.rs:138-180)."""

    def __init__(self, fr: Field, fq: Field):
        self.fr = fr
        self.fq = fq
        self.nq = (fq.bits + 7) // 8
        self.nr = (fr.bits + 7) // 8
        self.buf = bytearray()

    def add_scalar(self, v: int):
        self.buf += int(v % self.fr.p).to_bytes(self.nr, "big")

    def add_point(self, pt):
        if pt is None:
            self.buf += b"\x00" * (2 * self.nq)
        else:
            self.buf += int(pt[0]).to_bytes(self.nq, "big")
            self.buf += int(pt[1]).to_bytes(self.nq, "big")

    def challenge(self) -> int:
        return int.from_bytes(keccak256(bytes(self.buf)), "big") % self.fr.p


# -- helpers ---------------------------------------------------------------

def _zipc(fn, *xs):
    """Apply a linear device fn across share components (plain / Shamir:
    direct; Rep3: per (a, b) component)."""
    if xs and isinstance(xs[0], rep3.Share):
        return rep3.Share(fn(*[x.a for x in xs]), fn(*[x.b for x in xs]))
    return fn(*xs)


def _concat(shares):
    return _zipc(lambda *a: torch.cat(a, dim=0), *shares)


def _slice(x, sl):
    return _zipc(lambda a: a[sl], x)


def _rows(x) -> int:
    return (x.a if isinstance(x, rep3.Share) else x).shape[0]


def _mont_sum(field: Field, arr):
    """Tree-reduce mont limbs over axis 0."""
    n = arr.shape[0]
    while n > 1:
        half = (n + 1) // 2
        lo = arr[:half]
        hi = arr[half:n]
        if hi.shape[0] < half:
            hi = torch.cat([hi, mont.zeros(field, (half - hi.shape[0],),
                                           device=arr.device)])
        arr = mont.add(field, lo, hi)
        n = half
    return arr[0]


def scan(op, arr, reverse: bool = False):
    """Inclusive scan of an associative op over axis 0 by doubling
    (Hillis-Steele): log2(k) whole-vector steps. reverse=True scans from
    the end (suffix scan)."""
    k = arr.shape[0]
    d = 1
    while d < k:
        if reverse:
            arr = torch.cat([op(arr[:k - d], arr[d:]), arr[k - d:]])
        else:
            arr = torch.cat([arr[:d], op(arr[:k - d], arr[d:])])
        d *= 2
    return arr


def _cumprod_mont(field: Field, arr):
    return scan(lambda a, b: mont.mul(field, a, b), arr)


def _powers_mont(field: Field, x: int, k: int, device):
    """[1, x, x^2, ..., x^(k-1)] as Montgomery limbs, made on the device by
    doubling: [p, p * x^len(p)]."""
    out = mont.encode(field, [1], device=device)
    while out.shape[0] < k:
        step = mont.constant(field, pow(x, out.shape[0], field.p),
                             device=device)
        out = torch.cat([out, mont.mul(field, out, step)])
    return out[:k]


def _eval_share_poly(drv, field, poly, x_int: int):
    """Evaluate a share-coefficient poly at public x: one mul_public + tree
    sum (reference evaluate_poly_public, linear in shares)."""
    pw = _powers_mont(field, x_int, _rows(poly), drv.device)
    prod = drv.mul_public(poly, pw)
    return _zipc(lambda a: _mont_sum(field, a)[None], prod)


def _eval_public_poly(field, coeffs, x_int: int) -> int:
    pw = _powers_mont(field, x_int, coeffs.shape[0], coeffs.device)
    s = _mont_sum(field, mont.mul(field, coeffs, pw))
    return mont.decode(field, s[None], site="plonk.public_eval")[0]


def _array_prod_mul(drv, field, invert: bool, v1, v2, v3):
    """Prefix products of v1*v2*v3 in constant rounds via blinded opens
    (reference array_prod_mul, co-plonk/src/mpc/rep3.rs:182-218)."""
    k = _rows(v1)
    m = drv.mul(drv.mul(v1, v2), v3)
    r = drv.rand(k + 1)
    r_inv = drv.inv(r)
    r0 = _zipc(lambda a: a[:1].expand((k,) + a.shape[1:]), r_inv)
    unblind = drv.mul(r0, _slice(r, slice(1, None)))
    s = drv.mul(_slice(r, slice(0, k)), m)
    opened = drv.mul_open(s, _slice(r_inv, slice(1, None)))
    prefix = _cumprod_mont(field, opened)
    res = drv.mul_public(unblind, prefix)
    if invert:
        res = drv.inv(res)
    return res


def _div_by_x_minus(drv, field, poly, x_int: int):
    """Divide a share poly by (X - x), dropping the remainder.

    q_i = sum_{j>i} c_j x^{j-i-1}: a suffix sum of c_j*x^j scaled by
    x^-(i+1) (the reference's sequential div_by_zerofier recurrence,
    round5.rs:75-92, reformulated for whole vectors)."""
    n = _rows(poly)
    dev = drv.device
    xinv = pow(x_int, -1, field.p)
    pw = _powers_mont(field, x_int, n, dev)
    pwinv = _powers_mont(field, xinv, n, dev)
    xinv_m = mont.constant(field, xinv, device=dev)

    def per_comp(a):
        t = mont.mul(field, a, pw)
        suf = scan(lambda u, v: mont.add(field, u, v), t, reverse=True)
        # S_i = sum_{j>=i} t_j ; q_i = S_{i+1} * x^-(i+1)
        s_next = torch.cat([suf[1:], mont.zeros(field, (1,), device=dev)])
        return mont.mul(field, mont.mul(field, s_next, pwinv), xinv_m)

    q = _zipc(per_comp, poly)
    return _slice(q, slice(0, n - 1))


def _pad_rows(a, length):
    pad = length - a.shape[0]
    if pad <= 0:
        return a[:length]
    return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])


def _add_at0(drv, field, poly, c0: int):
    head = drv.add_public(_slice(poly, slice(0, 1)),
                          mont.constant(field, c0, (1,), device=drv.device))
    return _concat([head, _slice(poly, slice(1, None))])


# -- prover ----------------------------------------------------------------

def _curve_for(zk: PlonkZkey):
    if zk.fq.name == "bn254_fq":
        return curves.BN254_G1
    return curves.BLS12_381_G1


class _Public:
    """The zkey's public vectors on the device, each converted once per
    proof: (coeffs, evals on 4n) of the selectors and sigmas, the Lagrange
    evaluations, and p_tau as Jacobian points."""

    def __init__(self, zk: PlonkZkey, spec, device):
        def dev(a):
            with timing.blocking("plonk.public"):
                return torch.as_tensor(a.astype(np.int64), device=device)

        for name in ("qm", "ql", "qr", "qo", "qc", "s1", "s2", "s3"):
            coeffs, evals = getattr(zk, name)
            setattr(self, name, (dev(coeffs), dev(evals)))
        self.lagrange = [dev(evals) for _, evals in zk.lagrange]
        self.p_tau = load_g1_array(spec, zk.p_tau, device)


def prove(zk: PlonkZkey, drv, public_ints: list[int], witness_share,
          deterministic_b: bool = False, debug_hook=None,
          timings: dict | None = None) -> dict:
    """Run the 5-round prover. `public_ints` = wtns[0..=n_public]
    (leading 1 included; zeroed per snarkjs), `witness_share` = share vec of
    the remaining non-addition wires ((n_vars - n_additions - n_public - 1,
    nlimbs) components) on the driver's device.

    deterministic_b: b_i = i (reference Round1Challenges::deterministic,
    round1.rs:89-99), a test hook for KAT parity. `timings`, when given,
    receives each round's self seconds (the party's own, its turn held)
    and under "turn_wait" its turn waits inside them (synchronising the
    device; `groth16.prove._Clock`)."""
    fr, fq = zk.fr, zk.fq
    spec = _curve_for(zk)
    dev = drv.device
    clock = _Clock(timings, dev)
    n = zk.domain_size
    pow2 = n.bit_length() - 1
    roots = fr.groth16_roots()
    w_n = roots[pow2]
    w_4n = roots[pow2 + 2]
    dom = groth16_domain(fr, n)  # generator w_n, tables cached
    dom4 = groth16_domain(fr, 4 * n)  # generator w_4n
    pub = _Public(zk, spec, dev)

    def const(v: int, k: int):
        return mont.constant(fr, v, (k,), device=dev)

    def encode(vals):
        return mont.encode(fr, vals, device=dev)

    publics = [0] + [int(v) % fr.p for v in public_ints[1:]]

    # full witness vector: promoted publics ++ private ++ additions
    pub_share = drv.promote(encode(publics))
    full = _concat([pub_share, witness_share])

    # additions (wave-wise: an addition may reference earlier additions)
    n_base = zk.n_vars - zk.n_additions
    if zk.n_additions:
        done = np.zeros(zk.n_additions, bool)
        avail = n_base
        while not done.all():
            wave = ~done & (zk.add_a < avail) & (zk.add_b < avail)
            if not wave.any():
                raise ValueError("cyclic additions in plonk zkey")
            with timing.blocking("plonk.additions", syncs=4):
                ia, ib, ca, cb = (
                    torch.as_tensor(v[wave].astype(np.int64), device=dev)
                    for v in (zk.add_a, zk.add_b, zk.add_ca, zk.add_cb))
            wa = _zipc(lambda a: a.index_select(0, ia), full)
            wb = _zipc(lambda a: a.index_select(0, ib), full)
            term = drv.add(drv.mul_public(wa, ca), drv.mul_public(wb, cb))
            full = _concat([full, term])
            done |= wave
            avail = n_base + int(done.sum())

    # blinding shares b1..b11 (b[0..10])
    if deterministic_b:
        b = drv.promote(encode(list(range(11))))
    else:
        b = drv.rand(11)

    def bi(i):
        return _slice(b, slice(i, i + 1))

    # ---- Round 1 ---------------------------------------------------------
    def wire_poly(wire_map, blind0, blind1):
        with timing.blocking("plonk.wire_map"):
            idx = torch.as_tensor(wire_map.astype(np.int64), device=dev)
        buf = _zipc(lambda a: a.index_select(0, idx), full)
        pad = n - len(wire_map)
        if pad:
            buf = _concat([buf, drv.promote(mont.zeros(fr, (pad,),
                                                       device=dev))])
        poly = _zipc(dom.ifft, buf)
        ev4 = _zipc(lambda c: dom4.fft(_pad_rows(c, 4 * n)), poly)
        # blind: poly += (b0 X + b1)(X^n - 1) => poly[0] -= b1,
        # poly[1] -= b0, append [b1, b0]
        lead = _concat([blind1, blind0])
        head = drv.sub(_slice(poly, slice(0, 2)), lead)
        poly_b = _concat([head, _slice(poly, slice(2, None)), lead])
        return buf, poly_b, ev4

    buf_a, poly_a, ev_a = wire_poly(zk.map_a, bi(0), bi(1))
    buf_b, poly_b, ev_b = wire_poly(zk.map_b, bi(2), bi(3))
    buf_c, poly_c, ev_c = wire_poly(zk.map_c, bi(4), bi(5))

    p_tau = pub.p_tau
    commit_a, commit_b, commit_c = drv.commit_many(
        spec, [p_tau] * 3, [poly_a, poly_b, poly_c])
    clock.lap("round1")

    # ---- Round 2 ---------------------------------------------------------
    ts = Transcript(fr, fq)
    for cm in (zk.qm_c, zk.ql_c, zk.qr_c, zk.qo_c, zk.qc_c,
               zk.s1_c, zk.s2_c, zk.s3_c):
        ts.add_point(g1_to_ints(fq, cm))
    for v in publics[1:]:
        ts.add_scalar(v)
    ts.add_point(commit_a)
    ts.add_point(commit_b)
    ts.add_point(commit_c)
    beta = ts.challenge()
    ts2 = Transcript(fr, fq)
    ts2.add_scalar(beta)
    gamma = ts2.challenge()
    if debug_hook:
        debug_hook("A", commit_a)
        debug_hook("beta", beta)
        debug_hook("gamma", gamma)

    w_pows = _powers_mont(fr, w_n, n, dev)
    beta_w = mont.mul(fr, w_pows, const(beta, 1))
    gamma_m = const(gamma, n)
    k1 = zk.k1
    k2 = zk.k2
    beta_m = const(beta, n)

    n1 = drv.add_public(buf_a, mont.add(fr, beta_w, gamma_m))
    n2 = drv.add_public(
        buf_b, mont.add(fr, mont.mul(fr, beta_w, const(k1, n)), gamma_m))
    n3 = drv.add_public(
        buf_c, mont.add(fr, mont.mul(fr, beta_w, const(k2, n)), gamma_m))
    s1_sub = pub.s1[1][::4]
    s2_sub = pub.s2[1][::4]
    s3_sub = pub.s3[1][::4]
    d1 = drv.add_public(
        buf_a, mont.add(fr, mont.mul(fr, beta_m, s1_sub), gamma_m))
    d2 = drv.add_public(
        buf_b, mont.add(fr, mont.mul(fr, beta_m, s2_sub), gamma_m))
    d3 = drv.add_public(
        buf_c, mont.add(fr, mont.mul(fr, beta_m, s3_sub), gamma_m))

    # the numerator and denominator prefix-product chains are independent
    # multi-round protocols: overlap them on two channels when the driver
    # can fork (reference joins rounds over parallel nets, round1.rs:19)
    fork = getattr(drv, "fork_channels", None)
    if fork is not None:
        d_num, d_den = fork(2)
        num, den = join(
            lambda: _array_prod_mul(d_num, fr, False, n1, n2, n3),
            lambda: _array_prod_mul(d_den, fr, True, d1, d2, d3),
        )
    else:
        num = _array_prod_mul(drv, fr, False, n1, n2, n3)
        den = _array_prod_mul(drv, fr, True, d1, d2, d3)
    buffer_z = drv.mul(num, den)
    buffer_z = _zipc(lambda a: torch.roll(a, 1, dims=0), buffer_z)

    z_poly = _zipc(dom.ifft, buffer_z)
    ev_z = _zipc(lambda c: dom4.fft(_pad_rows(c, 4 * n)), z_poly)
    lead = _concat([bi(8), bi(7), bi(6)])  # [b8, b7, b6] -> coeff 0,1,2
    head = drv.sub(_slice(z_poly, slice(0, 3)), lead)
    z_poly = _concat([head, _slice(z_poly, slice(3, None)), lead])
    (commit_z,) = drv.commit_many(spec, [p_tau], [z_poly])
    clock.lap("round2")

    # ---- Round 3 ---------------------------------------------------------
    ts = Transcript(fr, fq)
    ts.add_scalar(beta)
    ts.add_scalar(gamma)
    ts.add_point(commit_z)
    alpha = ts.challenge()
    alpha2 = alpha * alpha % fr.p
    if debug_hook:
        debug_hook("Z", commit_z)
        debug_hook("alpha", alpha)
        debug_hook("buffer_z", buffer_z)
        debug_hook("T1c", None)

    len4 = 4 * n
    w4_m = _powers_mont(fr, w_4n, len4, dev)
    w4sq_m = mont.mul(fr, w4_m, w4_m)
    # blinding polys evaluated on the 4n domain (broadcast views: read only)
    bb = {i: _zipc(lambda a: a.expand((len4,) + a.shape[1:]), bi(i))
          for i in range(11)}
    ap = drv.add(drv.mul_public(bb[0], w4_m), bb[1])
    bp = drv.add(drv.mul_public(bb[2], w4_m), bb[3])
    cp = drv.add(drv.mul_public(bb[4], w4_m), bb[5])
    zp = drv.add(drv.add(drv.mul_public(bb[6], w4sq_m),
                         drv.mul_public(bb[7], w4_m)), bb[8])
    ww_m = mont.mul(fr, w4_m, const(w_n, 1))
    wwsq_m = mont.mul(fr, ww_m, ww_m)
    zwp = drv.add(drv.add(drv.mul_public(bb[6], wwsq_m),
                          drv.mul_public(bb[7], ww_m)), bb[8])
    zw = _zipc(lambda a: torch.roll(a, -4, dims=0), ev_z)

    # Z_H values on the 4n domain repeat with period 4: [0, w4-1, -2, -w4-1]
    w4r = pow(w_4n, n, fr.p)  # 4th root of unity
    zh1 = [0, (w4r - 1) % fr.p, fr.p - 2, (-w4r - 1) % fr.p]
    zh2 = [v * v % fr.p for v in zh1]
    zh3 = [v2 * v % fr.p for v2, v in zip(zh2, zh1)]

    def tile4(vals):
        return encode(vals).repeat(n, 1)

    z1_m, z2_m, z3_m = tile4(zh1), tile4(zh2), tile4(zh3)

    gamma4 = const(gamma, len4)
    e2a = drv.add_public(
        ev_a, mont.add(fr, mont.mul(fr, const(beta, len4), w4_m), gamma4))
    e2b = drv.add_public(
        ev_b, mont.add(fr, mont.mul(fr, const(beta * k1 % fr.p, len4),
                                    w4_m), gamma4))
    e2c = drv.add_public(
        ev_c, mont.add(fr, mont.mul(fr, const(beta * k2 % fr.p, len4),
                                    w4_m), gamma4))
    bconst = const(beta, len4)
    e3a = drv.add_public(
        ev_a, mont.add(fr, mont.mul(fr, bconst, pub.s1[1]), gamma4))
    e3b = drv.add_public(
        ev_b, mont.add(fr, mont.mul(fr, bconst, pub.s2[1]), gamma4))
    e3c = drv.add_public(
        ev_c, mont.add(fr, mont.mul(fr, bconst, pub.s3[1]), gamma4))

    # batched product level 1: raw a*b cross-blinding products (for e1/e1z)
    # + the mul4vec level-A products for e2/e3 (ap*bp is shared: blinding
    # polys are unshifted). ONE network round for all 18.
    l1_x = _concat([ev_a, ev_a, ap, ap,
                    e2a, e2a, ap, e2c, e2c, cp, cp,
                    e3a, e3a, ap, e3c, e3c, cp, cp])
    l1_y = _concat([ev_b, bp, ev_b, bp,
                    e2b, bp, e2b, ev_z, zp, ev_z, zp,
                    e3b, bp, e3b, zw, zwp, zw, zwp])
    l1 = drv.mul(l1_x, l1_y)
    parts = [_slice(l1, slice(i * len4, (i + 1) * len4)) for i in range(18)]
    a_b, a_bp, ap_b, ap_bp = parts[0:4]
    (e2_ab, e2_abp, e2_apb,
     e2_cd, e2_cdp, e2_cpd, e2_cpdp) = parts[4:11]
    (e3_ab, e3_abp, e3_apb,
     e3_cd, e3_cdp, e3_cpd, e3_cpdp) = parts[11:18]
    e2_apbp = ap_bp
    e3_apbp = ap_bp

    def lvl2(ab, abp, apb, apbp, cd, cdp, cpd, cpdp):
        AB = [ab, drv.add(abp, apb), apbp]
        CD = [cd, drv.add(cdp, cpd), cpdp]
        return AB, CD

    e2AB, e2CD = lvl2(e2_ab, e2_abp, e2_apb, e2_apbp,
                      e2_cd, e2_cdp, e2_cpd, e2_cpdp)
    e3AB, e3CD = lvl2(e3_ab, e3_abp, e3_apb, e3_apbp,
                      e3_cd, e3_cdp, e3_cpd, e3_cpdp)
    pairs = [(i, j) for i in range(3) for j in range(3)]
    l2_x = _concat([e2AB[i] for i, _ in pairs] + [e3AB[i] for i, _ in pairs])
    l2_y = _concat([e2CD[j] for _, j in pairs] + [e3CD[j] for _, j in pairs])
    l2 = drv.mul(l2_x, l2_y)
    p2 = [_slice(l2, slice(i * len4, (i + 1) * len4)) for i in range(18)]

    def collect(ps):
        by_k = {}
        for (i, j), v in zip(pairs, ps):
            by_k.setdefault(i + j, []).append(v)
        out = []
        for k in range(5):
            acc = by_k[k][0]
            for v in by_k[k][1:]:
                acc = drv.add(acc, v)
            out.append(acc)
        return out  # [prod, 1-primed, 2-primed, 3-primed, 4-primed]

    e2_terms = collect(p2[:9])
    e3_terms = collect(p2[9:])

    def zsum(terms):
        """terms[0] + terms[1..4] -> (full_product, zh-correction)."""
        full_ = terms[0]
        corr = terms[1]
        corr = drv.add(corr, drv.mul_public(terms[2], z1_m))
        corr = drv.add(corr, drv.mul_public(terms[3], z2_m))
        corr = drv.add(corr, drv.mul_public(terms[4], z3_m))
        return full_, corr

    e2, e2z = zsum(e2_terms)
    e3, e3z = zsum(e3_terms)

    # e1: gate identity (unblinded/blinded split)
    qm_e, ql_e, qr_e, qo_e, qc_e = (pub.qm[1], pub.ql[1], pub.qr[1],
                                    pub.qo[1], pub.qc[1])
    e1 = drv.mul_public(a_b, qm_e)
    e1 = drv.add(e1, drv.mul_public(ev_a, ql_e))
    e1 = drv.add(e1, drv.mul_public(ev_b, qr_e))
    e1 = drv.add(e1, drv.mul_public(ev_c, qo_e))
    # e1z: d/dZH part of (a + ap ZH)(b + bp ZH) Qm + blinded linear terms
    a0 = drv.add(drv.add(a_bp, ap_b), drv.mul_public(ap_bp, z1_m))
    e1z = drv.mul_public(a0, qm_e)
    e1z = drv.add(e1z, drv.mul_public(ap, ql_e))
    e1z = drv.add(e1z, drv.mul_public(bp, qr_e))
    e1z = drv.add(e1z, drv.mul_public(cp, qo_e))
    # public-input polynomial: -sum_j buffer_a[j] * L_j(x)  (j < n_public)
    pi = None
    for j, le in enumerate(pub.lagrange):
        term = drv.mul_public(
            _zipc(lambda a: a[j:j + 1].expand((len4,) + a.shape[1:]), buf_a),
            le)
        pi = term if pi is None else drv.add(pi, term)
    if pi is not None:
        e1 = drv.sub(e1, pi)
    e1 = drv.add_public(e1, qc_e)

    l1_e = pub.lagrange[0]
    alpha_m = const(alpha, len4)
    alpha2_m = const(alpha2, len4)
    e2 = drv.mul_public(e2, alpha_m)
    e2z = drv.mul_public(e2z, alpha_m)
    e3 = drv.mul_public(e3, alpha_m)
    e3z = drv.mul_public(e3z, alpha_m)
    e4 = drv.add_public(ev_z, const(fr.p - 1, len4))
    e4 = drv.mul_public(e4, mont.mul(fr, l1_e, alpha2_m))
    e4z = drv.mul_public(zp, mont.mul(fr, l1_e, alpha2_m))

    t_vec = drv.add(drv.sub(drv.add(e1, e2), e3), e4)
    tz_vec = drv.add(drv.sub(drv.add(e1z, e2z), e3z), e4z)

    coeff_t = _zipc(dom4.ifft, t_vec)

    # divide by Z_H = X^n - 1 on coefficients: negate low block, then
    # c[i] = c[i-n] - c[i] with already-updated c[i-n] (4 vector blocks)
    def zh_div(c):
        blocks = [c[i * n:(i + 1) * n] for i in range(4)]
        out = [mont.neg(fr, blocks[0])]
        for i in range(1, 4):
            out.append(mont.sub(fr, out[i - 1], blocks[i]))
        return torch.cat(out, dim=0)

    coeff_t = _zipc(zh_div, coeff_t)
    coeff_tz = _zipc(dom4.ifft, tz_vec)
    t_final = drv.add(coeff_t, coeff_tz)

    t1 = _concat([_slice(t_final, slice(0, n)), bi(9)])
    t2_head = drv.sub(_slice(t_final, slice(n, n + 1)), bi(9))
    t2 = _concat([t2_head, _slice(t_final, slice(n + 1, 2 * n)), bi(10)])
    t3_head = drv.sub(_slice(t_final, slice(2 * n, 2 * n + 1)), bi(10))
    t3 = _concat([t3_head, _slice(t_final, slice(2 * n + 1, 3 * n + 6))])

    commit_t1, commit_t2, commit_t3 = drv.commit_many(
        spec, [p_tau] * 3, [t1, t2, t3])
    clock.lap("round3")

    # ---- Round 4 ---------------------------------------------------------
    ts = Transcript(fr, fq)
    ts.add_scalar(alpha)
    ts.add_point(commit_t1)
    ts.add_point(commit_t2)
    ts.add_point(commit_t3)
    xi = ts.challenge()
    xiw = xi * w_n % fr.p

    evals = _concat([
        _eval_share_poly(drv, fr, poly_a, xi),
        _eval_share_poly(drv, fr, poly_b, xi),
        _eval_share_poly(drv, fr, poly_c, xi),
        _eval_share_poly(drv, fr, z_poly, xiw),
    ])
    opened = mont.decode(fr, drv.open_many(evals), site="plonk.open")
    eval_a, eval_b, eval_c, eval_zw = [int(v) for v in opened]
    eval_s1 = _eval_public_poly(fr, pub.s1[0], xi)
    eval_s2 = _eval_public_poly(fr, pub.s2[0], xi)
    clock.lap("round4")

    # ---- Round 5 ---------------------------------------------------------
    ts = Transcript(fr, fq)
    ts.add_scalar(xi)
    for v in (eval_a, eval_b, eval_c, eval_s1, eval_s2, eval_zw):
        ts.add_scalar(v)
    v0 = ts.challenge()
    v = [v0, v0 * v0 % fr.p, pow(v0, 3, fr.p), pow(v0, 4, fr.p),
         pow(v0, 5, fr.p)]

    # lagrange evaluations at xi + PI(xi)
    xin = pow(xi, n, fr.p)
    zh = (xin - 1) % fr.p
    l_len = max(1, zk.n_public)
    l_evals = []
    wp = 1
    n_f = n % fr.p
    for _ in range(l_len):
        denom = n_f * (xi - wp) % fr.p
        l_evals.append(wp * zh % fr.p * pow(denom, -1, fr.p) % fr.p)
        wp = wp * w_n % fr.p
    eval_pi = 0
    for val, lv in zip(publics[1:], l_evals):
        eval_pi = (eval_pi - lv * val) % fr.p

    coef_ab = eval_a * eval_b % fr.p
    betaxi = beta * xi % fr.p
    e2a_s = (eval_a + betaxi + gamma) % fr.p
    e2b_s = (eval_b + betaxi * k1 + gamma) % fr.p
    e2c_s = (eval_c + betaxi * k2 + gamma) % fr.p
    e2_s = e2a_s * e2b_s % fr.p * e2c_s % fr.p * alpha % fr.p
    e3a_s = (eval_a + beta * eval_s1 + gamma) % fr.p
    e3b_s = (eval_b + beta * eval_s2 + gamma) % fr.p
    e3_s = e3a_s * e3b_s % fr.p * eval_zw % fr.p * alpha % fr.p
    e4_s = alpha2 * l_evals[0] % fr.p
    e24 = (e2_s + e4_s) % fr.p

    # public part of R
    nlen = pub.qm[0].shape[0]
    r_pub = mont.mul(fr, pub.qm[0], const(coef_ab, nlen))
    for coeffs, fac in ((pub.ql[0], eval_a), (pub.qr[0], eval_b),
                        (pub.qo[0], eval_c)):
        r_pub = mont.add(fr, r_pub, mont.mul(fr, coeffs, const(fac, nlen)))
    r_pub = mont.add(fr, r_pub, pub.qc[0])
    s3fac = (fr.p - e3_s * beta % fr.p) % fr.p
    r_pub = mont.add(fr, r_pub, mont.mul(fr, pub.s3[0], const(s3fac, nlen)))

    length = n + 6

    def padded(x):
        return _zipc(lambda a: _pad_rows(a, length), x)

    poly_r = drv.mul_public(padded(z_poly), const(e24, length))
    poly_r = drv.add_public(poly_r, _pad_rows(r_pub, length))
    xin2 = xin * xin % fr.p
    tmp = drv.mul_public(padded(t3), const(xin2, length))
    tmp = drv.add(tmp, drv.mul_public(padded(t2), const(xin, length)))
    tmp = drv.add(tmp, padded(t1))
    tmp = drv.mul_public(tmp, const(zh, length))
    poly_r = drv.sub(poly_r, tmp)
    r0 = (eval_pi - e3_s * (eval_c + gamma) - e4_s) % fr.p
    poly_r = _add_at0(drv, fr, poly_r, r0)

    # Wxi
    wxi = poly_r
    for poly, fac in ((poly_a, v[0]), (poly_b, v[1]), (poly_c, v[2])):
        wxi = drv.add(wxi, drv.mul_public(padded(poly), const(fac, length)))
    for coeffs, fac in ((pub.s1[0], v[3]), (pub.s2[0], v[4])):
        wxi = drv.add_public(wxi, _pad_rows(
            mont.mul(fr, coeffs, const(fac, coeffs.shape[0])), length))
    c0 = (- v[0] * eval_a - v[1] * eval_b - v[2] * eval_c
          - v[3] * eval_s1 - v[4] * eval_s2) % fr.p
    wxi = _add_at0(drv, fr, wxi, c0)
    wxi = _div_by_x_minus(drv, fr, wxi, xi)

    # Wxiw
    wxiw = _add_at0(drv, fr, z_poly, (fr.p - eval_zw) % fr.p)
    wxiw = _div_by_x_minus(drv, fr, wxiw, xiw)

    commit_wxi, commit_wxiw = drv.commit_many(
        spec, [p_tau] * 2, [wxi, wxiw])
    clock.lap("round5")

    def fmt(pt):
        if pt is None:
            return ["0", "1", "0"]
        return [str(pt[0]), str(pt[1]), "1"]

    return {
        "A": fmt(commit_a), "B": fmt(commit_b), "C": fmt(commit_c),
        "Z": fmt(commit_z),
        "T1": fmt(commit_t1), "T2": fmt(commit_t2), "T3": fmt(commit_t3),
        "Wxi": fmt(commit_wxi), "Wxiw": fmt(commit_wxiw),
        "eval_a": str(eval_a), "eval_b": str(eval_b),
        "eval_c": str(eval_c), "eval_s1": str(eval_s1),
        "eval_s2": str(eval_s2), "eval_zw": str(eval_zw),
        "protocol": "plonk",
        "curve": "bn128" if fr.name.startswith("bn254") else "bls12381",
    }
