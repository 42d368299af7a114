"""The expected value of a party's share MSM: with points P_i = [k_i]G and
Montgomery-form scalars m_i (standard form s_i = m_i / 2^256 mod r),
sum_i s_i P_i = [sum_i s_i k_i] G."""

from __future__ import annotations

from .bn254 import G1, R, from_mont


def expected(dlogs: list[int], scalars_mont: list[int]):
    """Affine [sum_i from_mont(m_i) k_i] G, or None for infinity."""
    if len(dlogs) != len(scalars_mont):
        raise ValueError("one scalar a point")
    acc = sum(k * m for k, m in zip(dlogs, scalars_mont)) % R
    return G1.mul(G1.gen, from_mont(acc, R))
