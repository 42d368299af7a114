"""circom .r1cs parser (header + constraints + wire map): port of
cosnarks_tpu.io.r1cs (numpy only).

Coefficients are standard-form LE field elements; constraints are triples of
linear combinations (A, B, C) with A*w . B*w = C*w.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..ff.bigint import limbs_to_int
from .binformat import Container, le_bytes_to_limbs, read_u32


@dataclasses.dataclass
class R1CS:
    prime: int
    n_vars: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    n_constraints: int
    # flat COO entries for the three matrices (standard-form limb values)
    matrix: np.ndarray  # 0=A 1=B 2=C
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray  # (nnz, nlimbs)

    @property
    def n_public(self) -> int:
        """Instance variables excluding the leading 1 wire."""
        return self.n_pub_out + self.n_pub_in


def parse_r1cs(data: bytes) -> R1CS:
    c = Container(data, b"r1cs")
    h = c.section(1)
    n8, off = read_u32(h, 0)
    prime = limbs_to_int(le_bytes_to_limbs(h[off : off + n8], n8)[0])
    off += n8
    n_vars, off = read_u32(h, off)
    n_pub_out, off = read_u32(h, off)
    n_pub_in, off = read_u32(h, off)
    n_prv_in, off = read_u32(h, off)
    n_labels = struct.unpack_from("<Q", h, off)[0]
    off += 8
    n_constraints, off = read_u32(h, off)

    sv = bytes(c.section(2))
    ms, rs, cs, vs = [], [], [], []
    off = 0
    for row in range(n_constraints):
        for m in range(3):
            n_entries, off = read_u32(sv, off)
            for _ in range(n_entries):
                wire, off = read_u32(sv, off)
                val = le_bytes_to_limbs(sv[off : off + n8], n8)[0]
                off += n8
                ms.append(m)
                rs.append(row)
                cs.append(wire)
                vs.append(val)
    nl = n8 // 2
    return R1CS(
        prime=prime,
        n_vars=n_vars,
        n_pub_out=n_pub_out,
        n_pub_in=n_pub_in,
        n_prv_in=n_prv_in,
        n_labels=n_labels,
        n_constraints=n_constraints,
        matrix=np.array(ms, dtype=np.uint32),
        row=np.array(rs, dtype=np.uint32),
        col=np.array(cs, dtype=np.uint32),
        val=(
            np.stack(vs) if vs else np.zeros((0, nl), dtype=np.uint32)
        ),
    )


def load_r1cs(path) -> R1CS:
    with open(path, "rb") as f:
        return parse_r1cs(f.read())
