"""snarkjs .wtns witness file reader/writer (values in standard form LE):
port of cosnarks_tpu.io.wtns (numpy only)."""

from __future__ import annotations

import struct

import numpy as np

from ..ff.bigint import limbs_to_int
from ..ff.spec import Field
from .binformat import Container, le_bytes_to_limbs, limbs_to_le_bytes, read_u32, write_container


def parse_wtns(data: bytes):
    """Returns (prime: int, values: (N, nlimbs) uint32 standard-form limbs)."""
    c = Container(data, b"wtns")
    h = c.section(1)
    n8, off = read_u32(h, 0)
    prime = limbs_to_int(le_bytes_to_limbs(h[off : off + n8], n8)[0])
    off += n8
    n, off = read_u32(h, off)
    vals = le_bytes_to_limbs(c.section(2), n8)
    if vals.shape[0] != n:
        raise ValueError("wtns length mismatch")
    return prime, vals


def load_wtns(path):
    with open(path, "rb") as f:
        return parse_wtns(f.read())


def write_wtns(field: Field, values: np.ndarray) -> bytes:
    """(N, nlimbs) standard-form limbs -> wtns bytes."""
    n8 = field.nlimbs * 2
    header = (
        struct.pack("<I", n8)
        + limbs_to_le_bytes(np.asarray(field.p_limbs)[None, :])
        + struct.pack("<I", values.shape[0])
    )
    return write_container(
        b"wtns", 2, [(1, header), (2, limbs_to_le_bytes(values))]
    )
