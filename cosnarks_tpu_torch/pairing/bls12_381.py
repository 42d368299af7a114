"""Host-side BLS12-381 pairing (reduced Tate, denominator elimination).

Tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - (1+u)); Fq12 = Fq6[w]/(w^2-v).
G2 lives on the M-twist E': y^2 = x^3 + 4(1+u); the untwist into E(Fq12) is
(x, y) -> (x * v^2/xi, (y/xi) * v * w)   [since w^-2 = v^-1 = v^2/xi and
w^-3 = (v/xi) * w], keeping line values sparse.

Same verification-equivalence argument as bn254.py: any reduced pairing
differs from the ate pairing by a fixed exponent coprime to r.
"""

from __future__ import annotations

from ..ff.spec import BLS12_381_FQ, BLS12_381_FR
from .tower import make_fp, make_fp2

Q = BLS12_381_FQ.p
R = BLS12_381_FR.p

Fp = make_fp(Q)
Fp2 = make_fp2(Q)


def _mul_by_xi(a: "Fp2") -> "Fp2":
    # xi = 1 + u: (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
    return Fp2(a.c0 - a.c1, a.c0 + a.c1)


class Fp6:
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
        c0 = t0 + _mul_by_xi((a1 + a2) * (b1 + b2) - t1 - t2)
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + _mul_by_xi(t2)
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def mul_by_v(self):
        return Fp6(_mul_by_xi(self.c2), self.c0, self.c1)

    def inv(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a * a - _mul_by_xi(b * c)
        t1 = _mul_by_xi(c * c) - a * b
        t2 = b * b - a * c
        d = (a * t0 + _mul_by_xi(c * t1 + b * t2)).inv()
        return Fp6(t0 * d, t1 * d, t2 * d)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2


class Fp12:
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
        if e < 0:
            return self.inv().pow(-e)
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

    def is_one(self):
        return self == Fp12.one()


def _sparse_line(w0: "Fp2", v2c0: "Fp2", v1c1: "Fp2") -> Fp12:
    """w0 + v2c0 * v^2 (in c0) + v1c1 * v * w (in c1)."""
    z = Fp2.zero()
    return Fp12(Fp6(w0, z, v2c0), Fp6(z, v1c1, z))


FINAL_EXP = (Q**12 - 1) // R

# 1/xi precomputed in Fq2
_XI_INV = Fp2(1, 1).inv()


def miller_tate(P, Qp) -> Fp12:
    """f_{r,P}(psi(Q)), P affine G1 ints, Qp affine G2 int-pair coords."""
    if P is None or Qp is None:
        return Fp12.one()
    xp, yp = Fp(P[0]), Fp(P[1])
    xq_ = Fp2(*Qp[0]) * _XI_INV  # x_psi = xq/xi * v^2
    yq_ = Fp2(*Qp[1]) * _XI_INV  # y_psi = yq/xi * v * w
    f = Fp12.one()
    tx, ty = xp, yp
    for b in bin(R)[3:]:
        lam = (tx * tx * 3) * (ty + ty).inv()
        # line: (lam*tx - ty) - lam*x_psi + y_psi
        l = _sparse_line(
            Fp2(lam * tx - ty, Fp.zero()), xq_ * (-lam), yq_
        )
        f = f * f * l
        x3 = lam * lam - tx - tx
        ty = lam * (tx - x3) - ty
        tx = x3
        if b == "1":
            if tx == xp:
                # T == -P at the final bit: vertical line, killed by the
                # final exponentiation — skip
                continue
            lam = (ty - yp) * (tx - xp).inv()
            l = _sparse_line(
                Fp2(lam * tx - ty, Fp.zero()), xq_ * (-lam), yq_
            )
            f = f * l
            x3 = lam * lam - tx - xp
            ty = lam * (tx - x3) - ty
            tx = x3
    return f


def pairing(P, Qp) -> Fp12:
    return miller_tate(P, Qp).pow(FINAL_EXP)


def pairing_product_is_one(pairs) -> bool:
    f = Fp12.one()
    for P, Qp in pairs:
        f = f * miller_tate(P, Qp)
    return f.pow(FINAL_EXP).is_one()


def g1_neg(P):
    if P is None:
        return None
    return (P[0], (-P[1]) % Q)
