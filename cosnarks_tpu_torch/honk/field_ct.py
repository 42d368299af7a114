"""Port of `cosnarks_tpu.honk.field_ct`: host Python, copied unchanged.

FieldCT: the lazy affine circuit-value abstraction.

Port of co-builder/src/types/field_ct.rs for the plain builder: a circuit
value is `witness * multiplicative_constant + additive_constant` (or a
pure constant), so additions/scalings by constants are gate-free and a
gate is only emitted on multiply / normalize / three-way add.
"""

from __future__ import annotations

from .builder import IS_CONSTANT, MulQuad, R, UltraBuilder


class FieldCT:
    __slots__ = ("add_c", "mul_c", "witness_index")

    def __init__(self, add_c=0, mul_c=1, witness_index=IS_CONSTANT):
        self.add_c = add_c % R
        self.mul_c = mul_c % R
        self.witness_index = witness_index

    @classmethod
    def from_witness_index(cls, idx: int) -> "FieldCT":
        return cls(0, 1, idx)

    @classmethod
    def from_constant(cls, v: int) -> "FieldCT":
        return cls(v % R, 1, IS_CONSTANT)

    @classmethod
    def from_witness(cls, value: int, builder: UltraBuilder) -> "FieldCT":
        return cls.from_witness_index(builder.add_variable(value))

    @classmethod
    def from_woc(cls, woc: tuple) -> "FieldCT":
        """("w", idx) | ("c", value) -> FieldCT."""
        kind, v = woc
        return (cls.from_witness_index(v) if kind == "w"
                else cls.from_constant(v))

    def is_constant(self) -> bool:
        return self.witness_index == IS_CONSTANT

    def is_normalized(self) -> bool:
        return self.is_constant() or (self.mul_c == 1 and self.add_c == 0)

    def get_value(self, builder: UltraBuilder):
        if self.is_constant():
            return self.add_c
        d = builder.d
        return d.add(d.mul(builder.get_variable(self.witness_index),
                           self.mul_c), self.add_c)

    def normalize(self, builder: UltraBuilder) -> "FieldCT":
        if self.is_normalized():
            return self
        out = self.get_value(builder)
        idx = builder.add_variable(out)
        builder.create_big_add_gate(self.witness_index, builder.zero_idx,
                                    idx, builder.zero_idx,
                                    self.mul_c, 0, -1 % R, 0, self.add_c)
        return FieldCT.from_witness_index(idx)

    def get_witness_index(self, builder: UltraBuilder) -> int:
        return self.normalize(builder).witness_index

    def add(self, other: "FieldCT", builder: UltraBuilder) -> "FieldCT":
        if (self.witness_index == other.witness_index
                and not self.is_constant()):
            return FieldCT(self.add_c + other.add_c, self.mul_c + other.mul_c,
                           self.witness_index)
        if self.is_constant() and other.is_constant():
            return FieldCT.from_constant(self.add_c + other.add_c)
        if other.is_constant():
            return FieldCT(self.add_c + other.add_c, self.mul_c,
                           self.witness_index)
        if self.is_constant():
            return FieldCT(self.add_c + other.add_c, other.mul_c,
                           other.witness_index)
        out = builder.d.add(self.get_value(builder),
                            other.get_value(builder))
        idx = builder.add_variable(out)
        builder.create_big_add_gate(self.witness_index, other.witness_index,
                                    idx, builder.zero_idx,
                                    self.mul_c, other.mul_c, -1 % R, 0,
                                    (self.add_c + other.add_c) % R)
        return FieldCT.from_witness_index(idx)

    def sub(self, other: "FieldCT", builder: UltraBuilder) -> "FieldCT":
        return self.add(other.neg(), builder)

    def neg(self) -> "FieldCT":
        return FieldCT(-self.add_c % R, -self.mul_c % R, self.witness_index)

    def add_two(self, a: "FieldCT", b: "FieldCT",
                builder: UltraBuilder) -> "FieldCT":
        """self + a + b in one big-mul gate (field_ct.rs:1327-1416)."""
        if self.is_constant() or a.is_constant() or b.is_constant():
            return self.add(a, builder).add(b, builder)
        out = builder.d.add(
            builder.d.add(self.get_value(builder), a.get_value(builder)),
            b.get_value(builder))
        idx = builder.add_variable(out)
        g = MulQuad(a=self.witness_index, b=a.witness_index,
                    c=b.witness_index, d=idx, mul_scaling=0,
                    a_scaling=self.mul_c, b_scaling=a.mul_c,
                    c_scaling=b.mul_c, d_scaling=-1 % R,
                    const_scaling=(self.add_c + a.add_c + b.add_c) % R)
        builder.create_big_mul_add_gate(g, False)
        return FieldCT.from_witness_index(idx)

    def multiply(self, other: "FieldCT", builder: UltraBuilder) -> "FieldCT":
        if self.is_constant() and other.is_constant():
            return FieldCT.from_constant(self.add_c * other.add_c)
        if other.is_constant():
            return FieldCT(self.add_c * other.add_c,
                           self.mul_c * other.add_c, self.witness_index)
        if self.is_constant():
            return FieldCT(self.add_c * other.add_c,
                           other.mul_c * self.add_c, other.witness_index)
        q_c = self.add_c * other.add_c % R
        q_r = self.add_c * other.mul_c % R
        q_l = self.mul_c * other.add_c % R
        q_m = self.mul_c * other.mul_c % R
        d = builder.d
        left = builder.get_variable(self.witness_index)
        right = builder.get_variable(other.witness_index)
        out = d.add(d.add(d.mul(q_m, d.mul(left, right)),
                          d.mul(q_l, left)),
                    d.add(d.mul(q_r, right), q_c))
        idx = builder.add_variable(out)
        builder.create_poly_gate(self.witness_index, other.witness_index,
                                 idx, q_m, q_l, q_r, -1 % R, q_c)
        return FieldCT.from_witness_index(idx)

    def assert_equal(self, other: "FieldCT", builder: UltraBuilder):
        """field_ct.rs assert_equal."""
        if self.is_constant() and other.is_constant():
            assert int(self.get_value(builder)) == int(
                other.get_value(builder))
        elif self.is_constant():
            idx = other.get_witness_index(builder)
            builder.assert_equal(idx,
                                 builder.put_constant_variable(self.add_c))
        elif other.is_constant():
            idx = self.get_witness_index(builder)
            builder.assert_equal(idx,
                                 builder.put_constant_variable(other.add_c))
        elif self.is_normalized() or other.is_normalized():
            builder.assert_equal(self.get_witness_index(builder),
                                 other.get_witness_index(builder))
        else:
            builder.create_big_add_gate(
                self.witness_index, other.witness_index, builder.zero_idx,
                builder.zero_idx, self.mul_c, -other.mul_c % R, 0, 0,
                (self.add_c - other.add_c) % R)
