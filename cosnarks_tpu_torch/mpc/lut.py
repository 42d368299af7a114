"""Port of `cosnarks_tpu.mpc.lut`: host Python, copied unchanged.

Secret-shared lookup-table providers.

Counterpart of the reference's LookupTableProvider abstraction
(mpc-core/src/lut.rs:12-71) with its two implementations: plain vectors
(PlainLookupTableProvider, lut.rs:75-140) and Rep3 tables backed by the
ring-OHV gadgets (rep3_ring/lut_field.rs:305-400). Tables hold field
values; indices may be public or secret-shared. A table stays public
(a plain list) until the first shared write forces promotion to shares.

Used by the Noir co-ACVM memory solver (MemoryInit/MemoryOp with shared
indices, co-noir/co-acvm/src/solver/memory_solver.rs) via the VM drivers.
"""

from __future__ import annotations

from ..ff.spec import Field
from .rep3_ring import (Rep3Ring, read_public_lut, read_shared_lut,
                        write_lut)
from .rep3_scalar import AShare, BShare, Rep3Scalar


class PlainLookupTableProvider:
    """Cleartext tables; indices must be public (lut.rs:75-140)."""

    def __init__(self, field: Field):
        self.p = field.p

    def init_public(self, values: list) -> list:
        return [int(v) % self.p for v in values]

    init_private = init_public

    def read(self, index, lut: list):
        return lut[int(index)]

    def write(self, index, value, lut: list) -> list:
        lut = list(lut)
        lut[int(index)] = int(value) % self.p
        return lut


class Rep3LookupTableProvider:
    """Rep3 tables with oblivious shared-index access: the index is
    bit-decomposed once (field A2B), its low log2(n) bits drive the
    packed one-hot-vector gadget, and reads/writes cost one or two
    reshare rounds past the OHV (rep3_ring/lut_field.rs via
    gadgets/{ohv,lut_field}.rs)."""

    RING_K = 32

    def __init__(self, proto: Rep3Scalar):
        self.fp = proto
        self.ring = Rep3Ring(proto.net, proto.rng, self.RING_K)
        self.p = proto.p

    def init_public(self, values: list) -> list:
        return list(values)

    init_private = init_public

    def _index_bits(self, index, n: int) -> BShare:
        """PRECONDITION: the shared index must be < 2^ceil(log2 n) — bits
        above k are dropped here (an index that large is a protocol error
        upstream). Indices in [n, 2^k) for non-power-of-two tables are
        caught by the OHV range check inside the gadgets (one opened
        error bit, rep3_ring._check_ohv_range)."""
        k = max(1, (n - 1).bit_length())
        if not isinstance(index, (AShare, BShare)):
            # public index against a shared table still routes through the
            # cheap local path in read/write; this is only for shared ones
            raise TypeError("public index needs no OHV")
        bits = index if isinstance(index, BShare) else self.fp.a2b(index)
        mask = (1 << k) - 1
        return BShare(bits.a & mask, bits.b & mask, k)

    def _promote_all(self, lut: list) -> list[AShare]:
        return [v if isinstance(v, AShare) else self.fp.promote(int(v))
                for v in lut]

    def read(self, index, lut: list):
        if not isinstance(index, (AShare, BShare)):
            return lut[int(index)]
        bits = self._index_bits(index, len(lut))
        if all(not isinstance(v, AShare) for v in lut):
            return read_public_lut(self.ring, self.fp,
                                   [int(v) % self.p for v in lut], bits)
        return read_shared_lut(self.ring, self.fp,
                               self._promote_all(lut), bits)

    def write(self, index, value, lut: list) -> list:
        if not isinstance(index, (AShare, BShare)):
            lut = list(lut)
            lut[int(index)] = value
            return lut
        bits = self._index_bits(index, len(lut))
        val = (value if isinstance(value, AShare)
               else self.fp.promote(int(value)))
        return write_lut(self.ring, self.fp, val,
                         self._promote_all(lut), bits)
