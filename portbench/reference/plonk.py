"""Plain snarkjs PLONK over BN254 for the benchmark's circuit: the circuit
itself (gates, additions, witness, copy cycles), the verifying key worked
out from the seed's tau, and the verifier (a frozen copy of the port's
host verifier, on this package's curves and Keccak).

The circuit is a squaring chain x_{i+1} = x_i^2 with two public inputs, x_0
and the chain's last value:
  - public gates: gate j has a = public signal j + 1 and qL = 1;
  - chain gates: a = b = x_i, c = x_{i+1}, qM = 1, qO = -1;
  - addition gates: snarkjs "additions" y_k = ca_k u_k + cb_k v_k, which
    the prover computes itself (u_k = y_{k-2} for k >= 2); gate a = y_k,
    b = u_k, c = v_k, qL = 1, qR = -ca_k, qO = -cb_k;
  - unused slots take signal 0; at least one padding row, whose slots map
    to themselves.
Sigma 1-3 follow the copy cycles over the cosets 1, k1 = 2 and k2 = 3.
"""

from __future__ import annotations

import hashlib

from .bn254 import G1, G2, Q, R, lagrange_all, pairing_product_is_one, \
    roots_of_unity
from .keccak import keccak256

K1, K2 = 2, 3
N_PUBLIC = 2


def draw(seed: bytes, tag: bytes, p: int = R) -> int:
    h = hashlib.blake2b(seed + tag, digest_size=32).digest()
    return int.from_bytes(h, "big") % p


def circuit(n: int, n_additions: int, seed: bytes, p: int = R):
    """(rows of (a, b, c, qm, ql, qr, qo) with signal ids and standard-form
    selector ints, additions (a, b, ca, cb), the wtns values of the
    non-addition signals)."""
    m = n - N_PUBLIC - n_additions - 1  # chain gates; one padding row
    if m < 2:
        raise ValueError("domain too small for the chain and additions")

    def sig(i):
        return 1 if i == 0 else 2 if i == m else i + 2

    x = [draw(seed, b"x0", p)]
    for _ in range(m):
        x.append(x[-1] * x[-1] % p)
    wtns = [1, x[0], x[m]] + x[1:m]
    n_base = len(wtns)
    rows = [(1, 0, 0, 0, 1, 0, 0), (2, 0, 0, 0, 1, 0, 0)]
    rows += [(sig(i), sig(i), sig(i + 1), 1, 0, 0, p - 1) for i in range(m)]
    adds = []
    for k in range(n_additions):
        u = n_base + k - 2 if k >= 2 else sig(k + 1)
        v = sig(k % m + 1)
        ca = draw(seed, b"ca%d" % k, p)
        cb = draw(seed, b"cb%d" % k, p)
        adds.append((u, v, ca, cb))
        rows.append((n_base + k, u, v, 0, 1, (p - ca) % p, (p - cb) % p))
    return rows, adds, wtns


def sigmas(rows, n: int, w_pows: list[int], p: int = R):
    """sigma_1..3 evaluations on the n domain: every signal's slots (a slots
    of every row, then b, then c) form one cycle; padding rows map to
    themselves. Slot (s, j) is the value k_s w^j."""
    ks = (1, K1, K2)
    slots: dict[int, list[tuple[int, int]]] = {}
    for s in range(3):
        for j, row in enumerate(rows):
            slots.setdefault(row[s], []).append((s, j))
    sigma = [[ks[s] * w_pows[j] % p for j in range(n)] for s in range(3)]
    for cycle in slots.values():
        for i, (s, j) in enumerate(cycle):
            s2, j2 = cycle[(i + 1) % len(cycle)]
            sigma[s][j] = ks[s2] * w_pows[j2] % p
    return sigma


def domain_powers(n: int, p: int = R) -> list[int]:
    w = roots_of_unity(p)[n.bit_length() - 1]
    out = [1] * n
    for j in range(1, n):
        out[j] = out[j - 1] * w % p
    return out


COMMITMENTS = ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3")


def vk(seed: bytes, domain_pow: int, n_additions: int) -> dict:
    """The verifying key from the seed's tau: [poly(tau)]G1 of each selector
    and sigma, poly(tau) = sum_j v_j L_j(tau), and X_2 = [tau]G2."""
    n = 1 << domain_pow
    rows = circuit(n, n_additions, seed)[0]
    tau = draw(seed, b"tau")
    L = lagrange_all(tau, n)

    def at_tau(vals):
        return sum(v * lj for v, lj in zip(vals, L)) % R

    def column(i):
        return [r[i] for r in rows] + [0] * (n - len(rows))

    polys = [column(i) for i in range(3, 7)] + [[0] * n]
    polys += sigmas(rows, n, domain_powers(n))
    out = {name: G1.mul(G1.gen, at_tau(v))
           for name, v in zip(COMMITMENTS, polys)}
    out.update({"X_2": G2.mul(G2.gen, tau), "k1": K1, "k2": K2,
                "power": domain_pow, "nPublic": N_PUBLIC})
    return out


class Transcript:
    """snarkjs Keccak256 transcript: 32-byte big-endian scalars and
    coordinates; infinity = 64 zero bytes; challenge = digest mod r."""

    def __init__(self):
        self.buf = bytearray()

    def add_scalar(self, v: int):
        self.buf += int(v % R).to_bytes(32, "big")

    def add_point(self, pt):
        if pt is None:
            self.buf += b"\x00" * 64
        else:
            self.buf += int(pt[0]).to_bytes(32, "big")
            self.buf += int(pt[1]).to_bytes(32, "big")

    def challenge(self) -> int:
        return int.from_bytes(keccak256(bytes(self.buf)), "big") % R


def _pt(v):
    """snarkjs JSON G1 [x, y, z] strings -> (x, y) ints or None."""
    x, y, z = (int(c) for c in v)
    return None if z == 0 else (x % Q, y % Q)


def verify(vk: dict, proof: dict, public_inputs) -> bool:
    """The snarkjs PLONK verifier (co-plonk plonk.rs:117-244): recompute the
    challenges from the vk and proof, evaluate R0 / D / E / F, and check
    e(Wxi + u Wxiw, [x]_2) == e(xi Wxi + u xi w Wxiw - E + F, [1]_2)."""
    p = R
    pubs = [int(v) % p for v in public_inputs]
    if vk["nPublic"] != len(pubs):
        return False
    n = 1 << vk["power"]
    k1, k2 = vk["k1"], vk["k2"]
    w_n = roots_of_unity()[vk["power"]]
    qm, ql, qr, qo, qc, s1, s2, s3 = (vk[k] for k in COMMITMENTS)
    A, Bp, C, Z = (_pt(proof[k]) for k in ("A", "B", "C", "Z"))
    T1, T2, T3 = (_pt(proof[k]) for k in ("T1", "T2", "T3"))
    Wxi, Wxiw = _pt(proof["Wxi"]), _pt(proof["Wxiw"])
    if not all(G1.on_curve(P) for P in (A, Bp, C, Z, T1, T2, T3, Wxi, Wxiw)):
        return False
    ea, eb, ec_, es1, es2, ezw = (
        int(proof[k]) % p for k in
        ("eval_a", "eval_b", "eval_c", "eval_s1", "eval_s2", "eval_zw"))

    ts = Transcript()
    for cm in (qm, ql, qr, qo, qc, s1, s2, s3):
        ts.add_point(cm)
    for v in pubs:
        ts.add_scalar(v)
    for P in (A, Bp, C):
        ts.add_point(P)
    beta = ts.challenge()
    ts = Transcript()
    ts.add_scalar(beta)
    gamma = ts.challenge()
    ts = Transcript()
    ts.add_scalar(beta)
    ts.add_scalar(gamma)
    ts.add_point(Z)
    alpha = ts.challenge()
    ts = Transcript()
    ts.add_scalar(alpha)
    for P in (T1, T2, T3):
        ts.add_point(P)
    xi = ts.challenge()
    ts = Transcript()
    ts.add_scalar(xi)
    for v in (ea, eb, ec_, es1, es2, ezw):
        ts.add_scalar(v)
    v0 = ts.challenge()
    v = [v0, v0 * v0 % p, pow(v0, 3, p), pow(v0, 4, p), pow(v0, 5, p)]
    ts = Transcript()
    ts.add_point(Wxi)
    ts.add_point(Wxiw)
    u = ts.challenge()

    xin = pow(xi, n, p)
    zh = (xin - 1) % p
    lag = []
    wp = 1
    for _ in range(max(1, len(pubs))):
        lag.append(wp * zh % p * pow(n * (xi - wp) % p, -1, p) % p)
        wp = wp * w_n % p
    pi = 0
    for val, li in zip(pubs, lag):
        pi = (pi - li * val) % p

    e2 = alpha * alpha % p * lag[0] % p
    e3a = (ea + es1 * beta + gamma) % p
    e3b = (eb + es2 * beta + gamma) % p
    e3 = e3a * e3b % p * (ec_ + gamma) % p * ezw % p * alpha % p
    r0 = (pi - e2 - e3) % p

    mul, add, neg = G1.mul, G1.add, G1.neg
    d1 = mul(qm, ea * eb)
    d1 = add(d1, mul(ql, ea))
    d1 = add(d1, mul(qr, eb))
    d1 = add(d1, mul(qo, ec_))
    d1 = add(d1, qc)
    betaxi = beta * xi % p
    d2a = (ea + betaxi + gamma) % p * ((eb + betaxi * k1 + gamma) % p) % p \
        * ((ec_ + betaxi * k2 + gamma) % p) % p * alpha % p
    d2 = mul(Z, (d2a + e2 + u) % p)
    d3 = mul(s3, e3a * e3b % p * (alpha * beta % p * ezw % p) % p)
    d4 = add(add(T1, mul(T2, xin)), mul(T3, xin * xin % p))
    d4 = mul(d4, zh)
    d = add(add(d1, d2), neg(d3))
    d = add(d, neg(d4))

    e_scalar = (v[0] * ea + v[1] * eb + v[2] * ec_ + v[3] * es1
                + v[4] * es2 + u * ezw - r0) % p
    E = mul(G1.gen, e_scalar)
    F = add(d, mul(A, v[0]))
    F = add(F, mul(Bp, v[1]))
    F = add(F, mul(C, v[2]))
    F = add(F, mul(s1, v[3]))
    F = add(F, mul(s2, v[4]))

    s = u * xi % p * w_n % p
    a1 = add(Wxi, mul(Wxiw, u))
    b1 = add(mul(Wxi, xi), mul(Wxiw, s))
    b1 = add(b1, neg(E))
    b1 = add(b1, F)
    if a1 is None or b1 is None:
        return False
    return pairing_product_is_one([(a1, vk["X_2"]), (neg(b1), G2.gen)])
