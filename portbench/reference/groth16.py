"""Plain Groth16 over BN254 for the squaring-chain key: the toxic waste from
the key's seed, the verifying key and any query point worked out from it,
and the snarkjs verification equation.

The circuit is the chain w_{i+1} = w_i^2 over the variables 1, x (public),
s_0 .. s_{n-1}, with the snarkjs public-binding rows appended to A, on the
domain of the next power of two at or above n + 2. The toxic waste is
blake2b(seed || tag) mod r for the tags tau, alpha, beta, gamma, delta,
which is how the benchmark asks the program to draw it.
"""

from __future__ import annotations

import hashlib

from .bn254 import (G1, G2, R, lagrange_at, pairing_product_is_one,
                    roots_of_unity)

N_PUBLIC = 1


def toxic_waste(seed: bytes) -> dict[str, int]:
    def draw(tag):
        h = hashlib.blake2b(seed + tag, digest_size=32).digest()
        return int.from_bytes(h, "big") % R

    return {t: draw(t.encode())
            for t in ("tau", "alpha", "beta", "gamma", "delta")}


def domain_size(n_constraints: int) -> int:
    n = 1
    while n < n_constraints + N_PUBLIC + 1:
        n *= 2
    return n


def chain_witness(x0: int, n_constraints: int) -> list[int]:
    """1, x, x^2, x^4, ...: the n_constraints + 2 variables."""
    w = [1, x0 % R]
    for _ in range(n_constraints):
        w.append(w[-1] * w[-1] % R)
    return w


class ChainKey:
    """The QAP values of the chain at tau, for any variable, and the key's
    points computed from them."""

    def __init__(self, seed: bytes, n_constraints: int):
        self.ncon = n_constraints
        self.n_vars = n_constraints + 2
        self.N = domain_size(n_constraints)
        self.t = toxic_waste(seed)

    def _L(self, js):
        return lagrange_at(self.t["tau"], self.N, js)

    def abc(self, i: int) -> tuple[int, int, int]:
        """A_i(tau), B_i(tau), C_i(tau)."""
        ncon = self.ncon
        want = []
        if 1 <= i <= ncon:
            want.append(i - 1)
        if i <= N_PUBLIC:
            want.append(ncon + i)
        if 2 <= i <= ncon + 1:
            want.append(i - 2)
        L = self._L(want)
        a = (L[i - 1] if 1 <= i <= ncon else 0)
        a += L[ncon + i] if i <= N_PUBLIC else 0
        b = L[i - 1] if 1 <= i <= ncon else 0
        c = L[i - 2] if 2 <= i <= ncon + 1 else 0
        return a % R, b, c

    def _lc(self, i: int) -> int:
        a, b, c = self.abc(i)
        return (self.t["beta"] * a + self.t["alpha"] * b + c) % R

    # the key's points, by name and index
    def a_query(self, i):
        return G1.mul(G1.gen, self.abc(i)[0])

    def b_g1_query(self, i):
        return G1.mul(G1.gen, self.abc(i)[1])

    def b_g2_query(self, i):
        return G2.mul(G2.gen, self.abc(i)[1])

    def c_query(self, j):
        """l_query: variable j + n_public + 1, divided by delta."""
        v = self._lc(j + N_PUBLIC + 1) * pow(self.t["delta"], -1, R) % R
        return G1.mul(G1.gen, v)

    def h_query(self, j):
        """The odd-coset Lagrange basis of the CircomReduction witness map:
        scale * rho w^j / (tau - rho w^j), rho the 2N-th root."""
        N, tau = self.N, self.t["tau"]
        roots = roots_of_unity()
        k = N.bit_length() - 1
        w, rho = roots[k], roots[k + 1]
        rhoN = pow(rho, N, R)
        z_tau = (pow(tau, N, R) - 1) % R
        zshift = (pow(tau, N, R) - rhoN) % R
        scale = (z_tau * pow(self.t["delta"], -1, R) % R
                 * pow((rhoN - 1) % R, -1, R) % R * pow(N, -1, R) % R
                 * zshift % R * pow(rhoN, -1, R) % R)
        pt = rho * pow(w, j, R) % R
        return G1.mul(G1.gen, scale * pt % R * pow((tau - pt) % R, -1, R)
                      % R)

    def vk(self) -> dict:
        t = self.t
        ginv = pow(t["gamma"], -1, R)
        return {
            "alpha_g1": G1.mul(G1.gen, t["alpha"]),
            "beta_g1": G1.mul(G1.gen, t["beta"]),
            "beta_g2": G2.mul(G2.gen, t["beta"]),
            "gamma_g2": G2.mul(G2.gen, t["gamma"]),
            "delta_g1": G1.mul(G1.gen, t["delta"]),
            "delta_g2": G2.mul(G2.gen, t["delta"]),
            "ic": [G1.mul(G1.gen, self._lc(i) * ginv % R)
                   for i in range(N_PUBLIC + 1)],
        }


def verify(vk: dict, proof: dict, public_inputs: list[int]) -> bool:
    """e(-A, B) e(alpha, beta) e(vk_x, gamma) e(C, delta) == 1, with every
    proof point on its curve."""
    a, b, c = proof["a"], proof["b"], proof["c"]
    if not (G1.on_curve(a) and G2.on_curve(b) and G1.on_curve(c)):
        return False
    if len(public_inputs) != len(vk["ic"]) - 1:
        return False
    acc = vk["ic"][0]
    for pt, x in zip(vk["ic"][1:], public_inputs):
        acc = G1.add(acc, G1.mul(pt, x))
    return pairing_product_is_one([
        (G1.neg(a), b), (vk["alpha_g1"], vk["beta_g2"]),
        (acc, vk["gamma_g2"]), (c, vk["delta_g2"])])
