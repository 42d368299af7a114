"""Plain snarkjs-PLONK verifier (host-side; port of
cosnarks_tpu.plonk.verify on the port's host curves and pairings).

Mirrors the reference verifier (co-plonk/src/plonk.rs:117-244): recompute
the Fiat-Shamir challenges from the vk + proof, evaluate R0/D/E/F, and
check e(Wxi + u*Wxiw, [x]_2) == e(xi*Wxi + u*xi*w*Wxiw - E + F, [1]_2).
"""

from __future__ import annotations

from ..ec import curves, host
from ..ff.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR
from ..pairing import bls12_381, bn254
from .prove import Transcript


def _pt(v):
    """snarkjs JSON G1 [x, y, z] strings -> (x, y) ints or None."""
    x, y, z = (int(c) for c in v)
    if z == 0:
        return None
    return (x, y)


def _g2(v):
    if int(v[2][0]) == 0 and int(v[2][1]) == 0:
        return None
    return ((int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1])))


def verify(vk: dict, proof: dict, public_inputs) -> bool:
    """vk = snarkjs verification_key.json dict; proof = snarkjs plonk proof
    dict; public_inputs = list of ints/strings."""
    if vk.get("curve") in ("bls12381", "bls12-381"):
        fr, fq = BLS12_381_FR, BLS12_381_FQ
        spec, pairing_mod = curves.BLS12_381_G1, bls12_381
    else:
        fr, fq = BN254_FR, BN254_FQ
        spec, pairing_mod = curves.BN254_G1, bn254
    p = fr.p
    pubs = [int(v) % p for v in public_inputs]
    if vk["nPublic"] != len(pubs):
        return False
    power = vk["power"]
    n = 1 << power
    k1, k2 = int(vk["k1"]), int(vk["k2"])
    roots = fr.groth16_roots()
    w_n = roots[power]

    qm, ql, qr, qo, qc = (_pt(vk[k]) for k in ("Qm", "Ql", "Qr", "Qo", "Qc"))
    s1, s2, s3 = (_pt(vk[k]) for k in ("S1", "S2", "S3"))
    A, Bp, C, Z = (_pt(proof[k]) for k in ("A", "B", "C", "Z"))
    T1, T2, T3 = (_pt(proof[k]) for k in ("T1", "T2", "T3"))
    Wxi, Wxiw = _pt(proof["Wxi"]), _pt(proof["Wxiw"])
    ea, eb, ec_, es1, es2, ezw = (
        int(proof[k]) % p for k in
        ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw")
    )

    # challenges (plonk.rs:33-100)
    ts = Transcript(fr, fq)
    for cm in (qm, ql, qr, qo, qc, s1, s2, s3):
        ts.add_point(cm)
    for v in pubs:
        ts.add_scalar(v)
    ts.add_point(A)
    ts.add_point(Bp)
    ts.add_point(C)
    beta = ts.challenge()
    ts = Transcript(fr, fq)
    ts.add_scalar(beta)
    gamma = ts.challenge()
    ts = Transcript(fr, fq)
    ts.add_scalar(beta)
    ts.add_scalar(gamma)
    ts.add_point(Z)
    alpha = ts.challenge()
    ts = Transcript(fr, fq)
    ts.add_scalar(alpha)
    ts.add_point(T1)
    ts.add_point(T2)
    ts.add_point(T3)
    xi = ts.challenge()
    ts = Transcript(fr, fq)
    ts.add_scalar(xi)
    for v in (ea, eb, ec_, es1, es2, ezw):
        ts.add_scalar(v)
    v0 = ts.challenge()
    v = [v0, v0 * v0 % p, pow(v0, 3, p), pow(v0, 4, p), pow(v0, 5, p)]
    ts = Transcript(fr, fq)
    ts.add_point(Wxi)
    ts.add_point(Wxiw)
    u = ts.challenge()

    # lagrange evals + PI
    xin = pow(xi, n, p)
    zh = (xin - 1) % p
    l_len = max(1, len(pubs))
    l = []
    wp = 1
    for _ in range(l_len):
        l.append(wp * zh % p * pow(n * (xi - wp) % p, -1, p) % p)
        wp = wp * w_n % p
    pi = 0
    for val, li in zip(pubs, l):
        pi = (pi - li * val) % p

    # R0 and D (plonk.rs:151-197)
    e2 = alpha * alpha % p * l[0] % p
    e3a = (ea + es1 * beta + gamma) % p
    e3b = (eb + es2 * beta + gamma) % p
    e3 = e3a * e3b % p * (ec_ + gamma) % p * ezw % p * alpha % p
    r0 = (pi - e2 - e3) % p

    hc = host.host_curve(spec)

    def lift(pt):
        return None if pt is None else tuple(hc._lift(c) for c in pt)

    def mul(pt, k):
        return None if pt is None else hc.mul(pt, k % p)

    def addp(x, y):
        return hc.add(x, y)

    d1 = mul(lift(qm), ea * eb % p)
    d1 = addp(d1, mul(lift(ql), ea))
    d1 = addp(d1, mul(lift(qr), eb))
    d1 = addp(d1, mul(lift(qo), ec_))
    d1 = addp(d1, lift(qc))
    betaxi = beta * xi % p
    d2a = (ea + betaxi + gamma) % p * ((eb + betaxi * k1 + gamma) % p) % p \
        * ((ec_ + betaxi * k2 + gamma) % p) % p * alpha % p
    d2 = mul(lift(Z), (d2a + e2 + u) % p)
    d3 = mul(lift(s3), e3a * e3b % p * (alpha * beta % p * ezw % p) % p)
    d4 = addp(addp(lift(T1), mul(lift(T2), xin)),
              mul(lift(T3), xin * xin % p))
    d4 = None if d4 is None else hc.mul(d4, zh)
    d = addp(addp(d1, d2), hc.neg(d3))
    d = addp(d, hc.neg(d4))

    # E and F
    e_scalar = (v[0] * ea + v[1] * eb + v[2] * ec_ + v[3] * es1
                + v[4] * es2 + u * ezw - r0) % p
    gen = tuple(hc._lift(c) for c in spec.generator)
    E = hc.mul(gen, e_scalar)
    F = addp(d, mul(lift(A), v[0]))
    F = addp(F, mul(lift(Bp), v[1]))
    F = addp(F, mul(lift(C), v[2]))
    F = addp(F, mul(lift(s1), v[3]))
    F = addp(F, mul(lift(s2), v[4]))

    # pairing: e(Wxi + u*Wxiw, X2) == e(xi*Wxi + u*xi*w*Wxiw - E + F, G2)
    s = u * xi % p * w_n % p
    a1 = addp(lift(Wxi), mul(lift(Wxiw), u))
    b1 = addp(mul(lift(Wxi), xi), mul(lift(Wxiw), s))
    b1 = addp(b1, hc.neg(E) if E is not None else None)
    b1 = addp(b1, F)
    if a1 is None or b1 is None:
        return False
    x2 = _g2(vk["X_2"])
    g2spec = (curves.BLS12_381_G2 if spec is curves.BLS12_381_G1
              else curves.BN254_G2)
    return pairing_mod.pairing_product_is_one([
        (hc._lower(a1), x2),
        (pairing_mod.g1_neg(hc._lower(b1)), g2spec.generator),
    ])
