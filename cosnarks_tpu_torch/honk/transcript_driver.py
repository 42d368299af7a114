"""Port of `cosnarks_tpu.honk.transcript_driver`: host Python, copied unchanged.

Native (python-int) Poseidon2 round helpers shared by the builder's
poseidon2 gate gadget — the same linear layers as gadgets/poseidon2.py,
exposed as in-place operations on 4-element int lists (mirrors mpc-core
poseidon2_permutation.rs external_round / internal_round)."""

from __future__ import annotations

from ..gadgets.poseidon2_params import PARAMS
from .builder import R

_PRM = PARAMS[4]
_DIAG = [v % R for v in _PRM["mat_diag_m_1"]]


class plain_matmuls:
    @staticmethod
    def matmul_m4(s):
        t0 = (s[0] + s[1]) % R
        t1 = (s[2] + s[3]) % R
        t2 = (2 * s[1] + t1) % R
        t3 = (2 * s[3] + t0) % R
        t4 = (4 * t1 + t3) % R
        t5 = (4 * t0 + t2) % R
        s[0] = (t3 + t5) % R
        s[1] = t5
        s[2] = (t2 + t4) % R
        s[3] = t4

    @staticmethod
    def matmul_external(s):
        plain_matmuls.matmul_m4(s)

    @staticmethod
    def matmul_internal(s):
        tot = sum(s) % R
        for i in range(4):
            s[i] = (s[i] * _DIAG[i] + tot) % R

    @staticmethod
    def external_round(s, rc):
        for i in range(4):
            v = (s[i] + rc[i]) % R
            v2 = v * v % R
            s[i] = v2 * v2 % R * v % R
        plain_matmuls.matmul_external(s)

    @staticmethod
    def internal_round(s, rc):
        v = (s[0] + rc) % R
        v2 = v * v % R
        s[0] = v2 * v2 % R * v % R
        plain_matmuls.matmul_internal(s)


class driver_matmuls:
    """Driver-generic Poseidon2 round helpers for the co-builder: the same
    linear layers over VM-driver values (ints or Rep3 shares); the S-box
    x^5 batches its 3 multiplication rounds across all 4 lanes (mirrors
    the reference co-builder's Poseidon2 gate witness generation,
    co-builder/src/types/poseidon2.rs)."""

    @staticmethod
    def matmul_m4(d, s):
        t0 = d.add(s[0], s[1])
        t1 = d.add(s[2], s[3])
        t2 = d.add(d.mul(2, s[1]), t1)
        t3 = d.add(d.mul(2, s[3]), t0)
        t4 = d.add(d.mul(4, t1), t3)
        t5 = d.add(d.mul(4, t0), t2)
        s[0] = d.add(t3, t5)
        s[1] = t5
        s[2] = d.add(t2, t4)
        s[3] = t4

    matmul_external = matmul_m4

    @staticmethod
    def matmul_internal(d, s):
        tot = d.add(d.add(s[0], s[1]), d.add(s[2], s[3]))
        for i in range(4):
            s[i] = d.add(d.mul(s[i], _DIAG[i]), tot)

    @staticmethod
    def _sbox_many(d, vs):
        v2 = d.mul_many(vs, vs)
        v4 = d.mul_many(v2, v2)
        return d.mul_many(v4, vs)

    @staticmethod
    def external_round(d, s, rc):
        vs = [d.add(s[i], rc[i]) for i in range(4)]
        out = driver_matmuls._sbox_many(d, vs)
        for i in range(4):
            s[i] = out[i]
        driver_matmuls.matmul_external(d, s)

    @staticmethod
    def internal_round(d, s, rc):
        v = d.add(s[0], rc)
        s[0] = driver_matmuls._sbox_many(d, [v])[0]
        driver_matmuls.matmul_internal(d, s)
