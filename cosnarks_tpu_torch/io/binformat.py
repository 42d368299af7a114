"""snarkjs/iden3 binary container format (zkey/wtns/r1cs share it): copy
of cosnarks_tpu.io.binformat (numpy only).

Replaces the reference's external `taceo-circom-types` parser crate
(re-exported at co-circom/co-circom/src/lib.rs:23-30). Field elements are
read as little-endian byte strings and reinterpreted as our 16-bit limb
arrays via numpy views — no python-int round trip, so multi-million-element
sections load at memory bandwidth.
"""

from __future__ import annotations

import struct

import numpy as np


class Container:
    def __init__(self, data: bytes, expected_magic: bytes):
        if data[:4] != expected_magic:
            raise ValueError(
                f"bad magic {data[:4]!r}, expected {expected_magic!r}"
            )
        self.data = data
        self.version, nsec = struct.unpack_from("<II", data, 4)
        self.sections: dict[int, list[tuple[int, int]]] = {}
        off = 12
        for _ in range(nsec):
            stype, slen = struct.unpack_from("<IQ", data, off)
            self.sections.setdefault(stype, []).append((off + 12, slen))
            off += 12 + slen

    def section(self, stype: int) -> memoryview:
        (off, slen), = self.sections[stype]
        return memoryview(self.data)[off : off + slen]


def le_bytes_to_limbs(buf, n8: int) -> np.ndarray:
    """(k*n8,) LE bytes -> (k, n8//2) uint32 16-bit limb array."""
    arr = np.frombuffer(buf, dtype="<u2").reshape(-1, n8 // 2)
    return arr.astype(np.uint32)


def limbs_to_le_bytes(limbs: np.ndarray) -> bytes:
    """(k, nlimbs) uint32 16-bit limbs -> LE bytes."""
    return np.ascontiguousarray(limbs.astype("<u2")).tobytes()


def read_u32(view, off) -> tuple[int, int]:
    return struct.unpack_from("<I", view, off)[0], off + 4


def write_container(magic: bytes, version: int, sections) -> bytes:
    """sections: list of (type, bytes)."""
    out = [magic, struct.pack("<II", version, len(sections))]
    for stype, body in sections:
        out.append(struct.pack("<IQ", stype, len(body)))
        out.append(body)
    return b"".join(out)
