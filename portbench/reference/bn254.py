"""BN254 in plain Python integers: the fields, the G1 and G2 groups, the
snarkjs root-of-unity chain, the decoding of 16-bit Montgomery limbs, and a
pairing-product check.

The benchmark's yardstick: it imports nothing of the program under test.
The pairing is a frozen copy of the port's host pairing (reduced Tate with
denominator elimination); any reduced pairing differs from the ate pairing
snarkjs uses by a fixed exponent coprime to r, so a product-of-pairings
check is equivalent.
"""

from __future__ import annotations

import numpy as np

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

LIMB_BITS = 16
NLIMBS = 16  # 16-bit limbs of a BN254 element; Montgomery R = 2^256
MONT_R = 1 << (LIMB_BITS * NLIMBS)
FIELD_BYTES = 32  # one BN254 Fq or Fr element

G1_GEN = (1, 2)
G2_GEN = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
           11559732032986387107991004021392285783925812861821192530917403151452391805634),
          (8495653923123431417604973247489272438418190587263600148770280649306958101930,
           4082367875863433681332203403145435568316851327593401208105741076214120093531))


# -- limbs -----------------------------------------------------------------

def limbs_to_ints(arr) -> list[int]:
    """(..., 16) little-endian 16-bit limbs (any integer dtype, values in
    [0, 2^16)) -> flat list of ints."""
    a = np.ascontiguousarray(np.asarray(arr).reshape(-1, NLIMBS),
                             dtype="<u2")
    raw = a.tobytes()
    step = 2 * NLIMBS
    return [int.from_bytes(raw[i:i + step], "little")
            for i in range(0, len(raw), step)]


def from_mont(x: int, p: int) -> int:
    """Montgomery form (R = 2^256) -> standard form mod p."""
    return x * pow(MONT_R, -1, p) % p


# -- Fq2 = Fq[u]/(u^2 + 1) as (c0, c1) tuples -------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    return ((t0 - t1) % Q, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % Q)


def f2_inv(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
    return (a[0] * n % Q, (-a[1]) * n % Q)


class _Fq:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)


class _Fq2:
    zero, one = (0, 0), (1, 0)
    add = staticmethod(f2_add)
    sub = staticmethod(f2_sub)
    mul = staticmethod(f2_mul)
    inv = staticmethod(f2_inv)


# -- short Weierstrass y^2 = x^3 + b, affine points or None (infinity) -----

class Curve:
    def __init__(self, F, b, gen):
        self.F, self.b, self.gen = F, b, gen

    def on_curve(self, P) -> bool:
        if P is None:
            return True
        F = self.F
        x, y = P
        return F.mul(y, y) == F.add(F.mul(F.mul(x, x), x), self.b)

    def neg(self, P):
        return None if P is None else (P[0], self.F.sub(self.F.zero, P[1]))

    def add(self, P, Qp):
        F = self.F
        if P is None:
            return Qp
        if Qp is None:
            return P
        if P[0] == Qp[0]:
            if P[1] != Qp[1] or P[1] == F.zero:
                return None
            lam = F.mul(F.mul(F.mul(P[0], P[0]), (3, 0) if F is _Fq2 else 3),
                        F.inv(F.add(P[1], P[1])))
        else:
            lam = F.mul(F.sub(Qp[1], P[1]), F.inv(F.sub(Qp[0], P[0])))
        x3 = F.sub(F.sub(F.mul(lam, lam), P[0]), Qp[0])
        return (x3, F.sub(F.mul(lam, F.sub(P[0], x3)), P[1]))

    # Jacobian (X, Y, Z), x = X/Z^2, y = Y/Z^3, for the scalar ladder
    def _jdouble(self, P):
        F = self.F
        X, Y, Z = P
        if Z == F.zero:
            return P
        A = F.mul(X, X)
        B = F.mul(Y, Y)
        C = F.mul(B, B)
        t = F.add(X, B)
        D = F.sub(F.sub(F.mul(t, t), A), C)
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        X3 = F.sub(F.mul(E, E), F.add(D, D))
        C8 = F.add(C, C)
        C8 = F.add(C8, C8)
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        YZ = F.mul(Y, Z)
        return (X3, Y3, F.add(YZ, YZ))

    def _jmadd(self, P, Qa):
        """Jacobian P + affine Qa (Qa not infinity)."""
        F = self.F
        X1, Y1, Z1 = P
        if Z1 == F.zero:
            return (Qa[0], Qa[1], F.one)
        Z1Z1 = F.mul(Z1, Z1)
        U2 = F.mul(Qa[0], Z1Z1)
        S2 = F.mul(F.mul(Qa[1], Z1), Z1Z1)
        H = F.sub(U2, X1)
        r = F.sub(S2, Y1)
        if H == F.zero:
            if r == F.zero:
                return self._jdouble(P)
            return (F.one, F.one, F.zero)
        HH = F.mul(H, H)
        HHH = F.mul(H, HH)
        V = F.mul(X1, HH)
        X3 = F.sub(F.sub(F.mul(r, r), HHH), F.add(V, V))
        Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.mul(Y1, HHH))
        return (X3, Y3, F.mul(Z1, H))

    def to_affine_jac(self, P):
        F = self.F
        X, Y, Z = P
        if Z == F.zero:
            return None
        zi = F.inv(Z)
        zi2 = F.mul(zi, zi)
        return (F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi)))

    def mul(self, P, k: int):
        """[k]P by a left-to-right ladder in Jacobian coordinates."""
        k %= R
        if P is None or k == 0:
            return None
        F = self.F
        acc = (F.one, F.one, F.zero)
        for bit in bin(k)[2:]:
            acc = self._jdouble(acc)
            if bit == "1":
                acc = self._jmadd(acc, P)
        return self.to_affine_jac(acc)


G1 = Curve(_Fq, 3, G1_GEN)
# b' = 3 / (9 + u) on the D-twist
G2 = Curve(_Fq2, f2_mul((3, 0), f2_inv((9, 1))), G2_GEN)


def decode_g1_jacobian_mont(x: int, y: int, z: int):
    """A Jacobian G1 point in Montgomery form (the device's layout) ->
    affine ints or None."""
    x, y, z = (from_mont(c, Q) for c in (x, y, z))
    return G1.to_affine_jac((x, y, z))


# -- the snarkjs root-of-unity chain of Fr ---------------------------------

def _two_adicity(p: int) -> tuple[int, int]:
    t, q = 0, p - 1
    while q % 2 == 0:
        q //= 2
        t += 1
    return t, q


def roots_of_unity(p: int = R) -> list[int]:
    """roots[k] has multiplicative order 2^k: z = qnr^trace for the
    smallest quadratic non-residue, roots = reversed([z, z^2, z^4, ...])
    (snarkjs / ffjavascript)."""
    t, trace = _two_adicity(p)
    qnr = 2
    while pow(qnr, (p - 1) // 2, p) != p - 1:
        qnr += 1
    roots = [pow(qnr, trace, p)]
    for _ in range(t):
        roots.append(roots[-1] * roots[-1] % p)
    roots.reverse()
    return roots


def lagrange_at(tau: int, n: int, indices, p: int = R) -> dict[int, int]:
    """L_j(tau) = (tau^n - 1) w^j / (n (tau - w^j)) over the size-n domain
    of generator roots[log2 n], for each j in `indices`."""
    w = roots_of_unity(p)[n.bit_length() - 1]
    z = (pow(tau, n, p) - 1) % p
    ninv = pow(n, -1, p)
    out = {}
    for j in indices:
        wj = pow(w, j, p)
        out[j] = z * wj % p * pow((tau - wj) % p, -1, p) % p * ninv % p
    return out


def lagrange_all(tau: int, n: int, p: int = R) -> list[int]:
    """L_j(tau) for every j < n, with one inversion (batch inverse)."""
    w = roots_of_unity(p)[n.bit_length() - 1]
    wj = [1] * n
    for j in range(1, n):
        wj[j] = wj[j - 1] * w % p
    den = [(tau - x) % p for x in wj]
    prefix = [1] * (n + 1)
    for i, d in enumerate(den):
        prefix[i + 1] = prefix[i] * d % p
    inv = pow(prefix[n], -1, p)
    dinv = [0] * n
    for i in range(n - 1, -1, -1):
        dinv[i] = prefix[i] * inv % p
        inv = inv * den[i] % p
    c = (pow(tau, n, p) - 1) % p * pow(n, -1, p) % p
    return [c * x % p * d % p for x, d in zip(wj, dinv)]


# -- pairing (frozen copy of the port's host pairing, BN254 only) ----------

class Fp:
    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % Q

    def __add__(self, o):
        return Fp(self.v + o.v)

    def __sub__(self, o):
        return Fp(self.v - o.v)

    def __neg__(self):
        return Fp(-self.v)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp(self.v * o)
        return Fp(self.v * o.v)

    __rmul__ = __mul__

    def inv(self):
        return Fp(pow(self.v, -1, Q))

    def __eq__(self, o):
        return isinstance(o, Fp) and self.v == o.v

    def is_zero(self):
        return self.v == 0

    @classmethod
    def zero(cls):
        return cls(0)


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = c0 if isinstance(c0, Fp) else Fp(c0)
        self.c1 = c1 if isinstance(c1, Fp) else Fp(c1)

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, (int, Fp)):
            return Fp2(self.c0 * o, self.c1 * o)
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def inv(self):
        ninv = (self.c0 * self.c0 + self.c1 * self.c1).inv()
        return Fp2(self.c0 * ninv, -(self.c1 * ninv))

    def mul_by_nonresidue_9u(self):
        return Fp2(self.c0 * 9 - self.c1, self.c0 + self.c1 * 9)

    def __eq__(self, o):
        return isinstance(o, Fp2) and self.c0 == o.c0 and self.c1 == o.c1

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    @classmethod
    def zero(cls):
        return cls(0, 0)

    @classmethod
    def one(cls):
        return cls(1, 0)


class Fp6:
    """c0 + c1 v + c2 v^2 over Fp2, v^3 = 9 + u."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0, c1, c2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @classmethod
    def zero(cls):
        return cls(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @classmethod
    def one(cls):
        return cls(Fp2.one(), Fp2.zero(), Fp2.zero())

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue_9u()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue_9u()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def mul_by_v(self):
        return Fp6(self.c2.mul_by_nonresidue_9u(), self.c0, self.c1)

    def inv(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a * a - (b * c).mul_by_nonresidue_9u()
        t1 = (c * c).mul_by_nonresidue_9u() - a * b
        t2 = b * b - a * c
        d = (a * t0 + (c * t1 + b * t2).mul_by_nonresidue_9u()).inv()
        return Fp6(t0 * d, t1 * d, t2 * d)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2


class Fp12:
    """c0 + c1 w over Fp6, w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0, self.c1 = c0, c1

    @classmethod
    def one(cls):
        return cls(Fp6.one(), Fp6.zero())

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def inv(self):
        d = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inv()
        return Fp12(self.c0 * d, -(self.c1 * d))

    def pow(self, e: int):
        acc = Fp12.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base * base
            e >>= 1
        return acc

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1


def _line(w0, w2, w3) -> Fp12:
    z = Fp2.zero()
    return Fp12(Fp6(w0, w2, z), Fp6(z, w3, z))


FINAL_EXP = (Q ** 12 - 1) // R


def _miller(P, Qp) -> Fp12:
    """f_{r,P}(psi(Q)), psi(x, y) = (x w^2, y w^3)."""
    if P is None or Qp is None:
        return Fp12.one()
    xp, yp = Fp(P[0]), Fp(P[1])
    xq, yq = Fp2(*Qp[0]), Fp2(*Qp[1])
    f = Fp12.one()
    tx, ty = xp, yp
    for b in bin(R)[3:]:
        lam = (tx * tx * 3) * (ty + ty).inv()
        f = (f * f) * _line(Fp2(lam * tx - ty, Fp.zero()), xq * (-lam), yq)
        x3 = lam * lam - tx - tx
        ty = lam * (tx - x3) - ty
        tx = x3
        if b == "1":
            if tx == xp:
                continue  # T = -P: a vertical line, killed by the final exp
            lam = (ty - yp) * (tx - xp).inv()
            f = f * _line(Fp2(lam * tx - ty, Fp.zero()), xq * (-lam), yq)
            x3 = lam * lam - tx - xp
            ty = lam * (tx - x3) - ty
            tx = x3
    return f


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for affine (G1, G2) pairs, one final
    exponentiation."""
    f = Fp12.one()
    for P, Qp in pairs:
        f = f * _miller(P, Qp)
    return f.pow(FINAL_EXP) == Fp12.one()


def decode_g1_affine_mont(arr):
    """A (2, 16) array of affine Montgomery limbs (the zkey layout; all
    zero = infinity) -> affine ints or None."""
    x, y = limbs_to_ints(arr)
    if x == 0 and y == 0:
        return None
    return (from_mont(x, Q), from_mont(y, Q))


def decode_g2_affine_mont(arr):
    """A (2, 2, 16) array of affine Fq2 Montgomery limbs -> affine or
    None."""
    x0, x1, y0, y1 = limbs_to_ints(arr)
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((from_mont(x0, Q), from_mont(x1, Q)),
            (from_mont(y0, Q), from_mont(y1, Q)))
