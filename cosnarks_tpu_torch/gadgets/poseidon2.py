"""Port of `cosnarks_tpu.gadgets.poseidon2`: host Python, copied unchanged.

Poseidon2 permutation, generic over the witness-extension driver seam.

Counterpart of the reference's Poseidon2 gadget
(mpc-core/src/gadgets/poseidon2/poseidon2_permutation.rs): x^5 S-box,
cheap 4x4 MDS external layer, sum+diagonal internal layer. Runs on plain
ints or secret shares through the same driver ops the circom VM and the
Noir ACVM use (driver.add/mul/...): external-round S-boxes are batched so
a t-wide round costs 3 share-mul rounds (x2, x4, x5).

MPC cost: (rounds_f * 3 + rounds_p * 3) mul rounds per permutation with
whole-state batching — the reference further amortizes with precomputed
randomness (Poseidon2Precomputations); that optimization can land behind
this same interface.
"""

from __future__ import annotations

from .poseidon2_params import PARAMS


class Poseidon2:
    def __init__(self, t: int, p: int):
        if t not in PARAMS:
            raise ValueError(f"no Poseidon2 BN254 params for t={t}")
        prm = PARAMS[t]
        self.t = t
        self.p = p
        self.rounds_f = prm["rounds_f"]
        self.rounds_p = prm["rounds_p"]
        self.diag = [v % p for v in prm["mat_diag_m_1"]]
        self.rc_ext = [[v % p for v in rc] for rc in prm["rc_external"]]
        self.rc_int = [v % p for v in prm["rc_internal"]]

    # -- linear layers (share-add only) --------------------------------------
    def _matmul_m4(self, d, s, off):
        t0 = d.add(s[off + 0], s[off + 1])
        t1 = d.add(s[off + 2], s[off + 3])
        t2 = d.add(d.add(s[off + 1], s[off + 1]), t1)
        t3 = d.add(d.add(s[off + 3], s[off + 3]), t0)
        t4 = d.add(d.add(d.add(t1, t1), d.add(t1, t1)), t3)
        t5 = d.add(d.add(d.add(t0, t0), d.add(t0, t0)), t2)
        s[off + 0] = d.add(t3, t5)
        s[off + 1] = t5
        s[off + 2] = d.add(t2, t4)
        s[off + 3] = t4

    def _matmul_external(self, d, s):
        t = self.t
        if t == 2:
            tot = d.add(s[0], s[1])
            s[0] = d.add(s[0], tot)
            s[1] = d.add(s[1], tot)
        elif t == 3:
            tot = d.add(d.add(s[0], s[1]), s[2])
            for i in range(3):
                s[i] = d.add(s[i], tot)
        elif t == 4:
            self._matmul_m4(d, s, 0)
        else:
            for off in range(0, t, 4):
                self._matmul_m4(d, s, off)
            stored = []
            for l in range(4):
                acc = s[l]
                for j in range(1, t // 4):
                    acc = d.add(acc, s[4 * j + l])
                stored.append(acc)
            for i in range(t):
                s[i] = d.add(s[i], stored[i % 4])

    def _matmul_internal(self, d, s):
        t = self.t
        tot = s[0]
        for i in range(1, t):
            tot = d.add(tot, s[i])
        for i in range(t):
            s[i] = d.add(d.mul(s[i], self.diag[i]), tot)

    # -- S-box ----------------------------------------------------------------
    def _sbox_many(self, d, xs):
        x2 = d.mul_many(xs, xs)
        x4 = d.mul_many(x2, x2)
        return d.mul_many(x4, xs)

    def permutation(self, d, state: list) -> list:
        """d: a driver with add/mul/mul_many (public ints or shares);
        state: list of t values. Returns the permuted state."""
        if len(state) != self.t:
            raise ValueError("state size mismatch")
        s = list(state)
        self._matmul_external(d, s)
        for r in range(self.rounds_f // 2):
            s = [d.add(x, rc) for x, rc in zip(s, self.rc_ext[r])]
            s = self._sbox_many(d, s)
            self._matmul_external(d, s)
        for r in range(self.rounds_p):
            s[0] = d.add(s[0], self.rc_int[r])
            s[0] = self._sbox_many(d, [s[0]])[0]
            self._matmul_internal(d, s)
        for r in range(self.rounds_f // 2, self.rounds_f):
            s = [d.add(x, rc) for x, rc in zip(s, self.rc_ext[r])]
            s = self._sbox_many(d, s)
            self._matmul_external(d, s)
        return s
