"""Port of `cosnarks_tpu.honk.builder`: host Python, copied unchanged.

UltraCircuitBuilder: ACIR -> Ultra execution trace -> proving key.

Python counterpart of the reference's GenericUltraCircuitBuilder
(co-noir/co-builder/src/ultra_builder.rs:163, acir_format.rs,
keys/plain_proving_key.rs), staged: this slice covers arithmetic
(quad / big-quad) constraints, the default pairing-point public inputs,
the ensure-nonzero gates (incl. the Honk dummy plookup), range
constraints via plookup decomposition + delta-range sort lists, logic
(AND/XOR) constraints via uint plookup tables, Poseidon2Permutation
gates, and ROM/RAM block constraints — enough for the bulk of the Noir
test corpus. Recursion constraints and bigfield/biggroup circuit types
are intentionally deferred (acir_format.rs:104-107 is explicitly staged
last in the reference too).

Everything here is the *plain* (single-party) builder; values are
canonical python ints mod r. The MPC (shared-witness) builder reuses this
gate layout with a driver seam — selectors and wire indices are public in
both cases, only `variables` values differ.
"""

from __future__ import annotations

import dataclasses

from ..ff.spec import BN254_FR
from . import polyops

R = BN254_FR.p

IS_CONSTANT = 0xFFFFFFFF
NUM_WIRES = 4
NUM_SELECTORS = 14
NUM_DISABLED_ROWS_IN_SUMCHECK = 4  # NUM_MASKED_ROWS + 1 (polynomial.rs:17-23)
NUM_RESERVED_GATES = 4
PUBLIC_INPUTS_SIZE = 8  # default pairing point accumulator (constants.rs)
PERMUTATION_SEPARATOR = 1 << 28
DEFAULT_PLOOKUP_RANGE_BITNUM = 14
DEFAULT_PLOOKUP_RANGE_STEP_SIZE = 3

# selector order = PrecomputedEntities columns 0..13 (entities.rs:255-283)
SELECTORS = ("q_m", "q_c", "q_l", "q_r", "q_o", "q_4", "q_lookup", "q_arith",
             "q_delta_range", "q_elliptic", "q_memory", "q_nnf",
             "q_pos_ext", "q_pos_int")

# trace block order (types.rs UltraTraceBlocks::get)
BLOCK_ORDER = ("pub_inputs", "lookup", "arithmetic", "delta_range",
               "elliptic", "memory", "nnf", "pos_ext", "pos_int")


@dataclasses.dataclass
class MulQuad:
    """ultra_builder.rs MulQuad: q_mul*ab + q_a*a + q_b*b + q_c_w*c +
    q_d*d + const = 0."""
    a: int
    b: int
    c: int
    d: int
    mul_scaling: int = 0
    a_scaling: int = 0
    b_scaling: int = 0
    c_scaling: int = 0
    d_scaling: int = 0
    const_scaling: int = 0


def split_into_mul_quad_gates(expr) -> list[MulQuad]:
    """acir_format.rs split_into_mul_quad_gates: one gate per mul term,
    linear terms packed into remaining wires, w4-shift chains the rest."""
    linear: dict[int, int] = {}
    for coef, w in expr.lin:
        linear[w] = (linear.get(w, 0) + coef) % R
    result: list[MulQuad] = []

    for coef, w1, w2 in expr.mul:
        g = MulQuad(a=w1, b=w2, c=IS_CONSTANT, d=IS_CONSTANT,
                    mul_scaling=coef % R)
        if g.a in linear:
            g.a_scaling = (g.a_scaling + linear.pop(g.a)) % R
        if g.b in linear:
            g.b_scaling = (g.b_scaling + linear.pop(g.b)) % R
        result.append(g)

    def take(keys_sorted):
        w = keys_sorted[0]
        return w, linear.pop(w)

    is_first_gate = True
    for g in result:
        if linear:
            w, cf = take(sorted(linear))
            g.c, g.c_scaling = w, (g.c_scaling + cf) % R
        if is_first_gate:
            g.const_scaling = expr.qc % R
            if linear:
                w, cf = take(sorted(linear))
                g.d, g.d_scaling = w, (g.d_scaling + cf) % R
            is_first_gate = False

    while linear:
        g = MulQuad(a=IS_CONSTANT, b=IS_CONSTANT, c=IS_CONSTANT,
                    d=IS_CONSTANT)
        for attr in ("a", "b", "c"):
            if linear:
                w, cf = take(sorted(linear))
                setattr(g, attr, w)
                setattr(g, attr + "_scaling", cf % R)
        if is_first_gate:
            g.const_scaling = expr.qc % R
            if linear:
                w, cf = take(sorted(linear))
                g.d, g.d_scaling = w, cf % R
            is_first_gate = False
        result.append(g)

    assert result, "expression produced no gates"
    return result


def is_single_arithmetic_gate(expr, linear: dict) -> bool:
    """acir_format.rs:1018-1071."""
    if len(linear) > NUM_WIRES:
        return False
    if len(expr.mul) > 1:
        return False
    if len(expr.mul) == 1:
        n = 2 + len(linear)
        _, lhs, rhs = expr.mul[0]
        if lhs != rhs:
            if lhs in linear:
                n -= 1
            if rhs in linear:
                n -= 1
        elif lhs in linear:
            n -= 1
        return n <= NUM_WIRES
    return len(linear) <= NUM_WIRES


@dataclasses.dataclass
class RangeConstraint:
    witness: int
    num_bits: int


@dataclasses.dataclass
class LogicConstraint:
    a: tuple  # ("w", idx) | ("c", value)
    b: tuple
    result: int
    num_bits: int
    is_xor: bool


@dataclasses.dataclass
class Poseidon2Constraint:
    state: list  # [("w", idx) | ("c", value)] * 4
    result: list  # witness indices * 4


@dataclasses.dataclass
class MemOp:
    access_type: int  # 0 read, 1 write
    index: tuple  # ("w", idx) | ("c", value)
    value: tuple


@dataclasses.dataclass
class BlockConstraint:
    init: list  # [witness index]
    trace: list  # [MemOp]
    type: str  # "ROM" | "RAM"


def _expr_to_woc(expr) -> tuple:
    """MemoryOp index/value expression -> witness-or-constant
    (acir_format.rs:915-955)."""
    assert not expr.mul, "MemoryOp with multiplication terms"
    assert len(expr.lin) <= 1, "MemoryOp with >1 linear term"
    a_scaling = expr.lin[0][0] % R if expr.lin else 0
    const = expr.qc % R
    if a_scaling == 1 and const == 0:
        return ("w", expr.lin[0][1])
    assert a_scaling == 0, "MemoryOp expression must be witness or constant"
    return ("c", const)


class AcirFormat:
    """acir_format.rs AcirFormat: the constraint lists the builder
    consumes, converted from a parsed ACIR function."""

    def __init__(self):
        self.max_witness_index = 0
        self.num_acir_opcodes = 0
        self.public_inputs: list[int] = []
        self.quad_constraints: list[MulQuad] = []
        self.big_quad_constraints: list[list[MulQuad]] = []
        self.range_constraints: list[RangeConstraint] = []
        self.logic_constraints: list[LogicConstraint] = []
        self.poseidon2_constraints: list[Poseidon2Constraint] = []
        self.block_constraints: list[BlockConstraint] = []
        self.unsupported: list[str] = []

    def _see(self, *witnesses):
        for w in witnesses:
            if w != IS_CONSTANT:
                self.max_witness_index = max(self.max_witness_index, int(w))

    def _see_expr(self, expr):
        for _, w1, w2 in expr.mul:
            self._see(w1, w2)
        for _, w in expr.lin:
            self._see(w)

    def _see_input(self, inp):
        if inp[0] == "w":
            self._see(inp[1])

    @classmethod
    def from_function(cls, fn) -> "AcirFormat":
        """Convert a noir.acir.AcirFunction (circuit_serde_to_acir_format,
        acir_format.rs:398-470)."""
        af = cls()
        af.num_acir_opcodes = len(fn.opcodes)
        af.public_inputs = list(fn.public_params) + list(fn.return_values)
        for w in af.public_inputs:
            af._see(w)
        blocks: dict[int, BlockConstraint] = {}
        for kind, payload in fn.opcodes:
            if kind == "assert_zero":
                af._see_expr(payload)
                linear: dict[int, int] = {}
                for coef, w in payload.lin:
                    linear[w] = (linear.get(w, 0) + coef) % R
                single = is_single_arithmetic_gate(payload, linear)
                quads = split_into_mul_quad_gates(payload)
                if single:
                    assert len(quads) == 1
                    af.quad_constraints.append(quads[0])
                else:
                    assert len(quads) > 1
                    af.big_quad_constraints.append(quads)
            elif kind == "blackbox":
                bb, args = payload
                af._add_blackbox(bb, args)
            elif kind == "memory_init":
                block_id, witnesses, block_type = payload
                af._see(*witnesses)
                blocks[block_id] = BlockConstraint(
                    init=[int(w) for w in witnesses], trace=[], type="ROM")
            elif kind == "memory_op":
                block_id, operation, index, value = payload
                af._see_expr(index)
                af._see_expr(value)
                blk = blocks[block_id]
                assert not operation.mul and not operation.lin, \
                    "memory op with non-constant access type unsupported"
                access = 0 if operation.qc % R == 0 else 1
                if access == 1:
                    blk.type = "RAM"
                blk.trace.append(MemOp(access_type=access,
                                       index=_expr_to_woc(index),
                                       value=_expr_to_woc(value)))
            elif kind == "brillig_call":
                pass  # solved during witness extension; adds no gates
            else:
                af.unsupported.append(kind)
        for block_id in sorted(blocks):
            af.block_constraints.append(blocks[block_id])
        return af

    def _add_blackbox(self, bb, args):
        from ..noir import acir as acir_mod

        fin = acir_mod._finput
        if bb == "RANGE":
            inp, bits = args
            w = fin(inp)
            assert w[0] == "w", "range on constant"
            self._see(w[1])
            self.range_constraints.append(RangeConstraint(w[1], int(bits)))
        elif bb in ("AND", "XOR"):
            lhs, rhs, bits, out = args
            a, b = fin(lhs), fin(rhs)
            self._see_input(a)
            self._see_input(b)
            self._see(int(out))
            self.logic_constraints.append(
                LogicConstraint(a, b, int(out), int(bits), bb == "XOR"))
        elif bb == "Poseidon2Permutation":
            inputs, outputs, _len = args[0], args[1], args[2] if len(args) > 2 else None
            state = [fin(i) for i in inputs]
            for s in state:
                self._see_input(s)
            result = [int(w) for w in outputs]
            self._see(*result)
            self.poseidon2_constraints.append(
                Poseidon2Constraint(state, result))
        else:
            self.unsupported.append(bb)


class TraceBlock:
    def __init__(self, is_pub_inputs=False, has_ram_rom=False):
        self.wires = [[] for _ in range(NUM_WIRES)]
        self.sel = {name: [] for name in SELECTORS}
        self.is_pub_inputs = is_pub_inputs
        self.has_ram_rom = has_ram_rom
        self.trace_offset = 0

    def __len__(self):
        return len(self.wires[0])

    def populate_wires(self, a, b, c, d):
        self.wires[0].append(a)
        self.wires[1].append(b)
        self.wires[2].append(c)
        self.wires[3].append(d)

    def push_selectors(self, **kw):
        for name in SELECTORS:
            self.sel[name].append(kw.get(name, 0) % R)

    def selector_columns(self):
        return [self.sel[name] for name in SELECTORS]


REAL_VARIABLE = (1 << 32) - 2
FIRST_IN_CLASS = (1 << 32) - 3
DUMMY_TAG = 0


@dataclasses.dataclass
class RangeList:
    target_range: int
    range_tag: int
    tau_tag: int
    variable_indices: list


class UltraBuilder:
    """UltraCircuitBuilder, generic over the witness-value driver
    (ultra_builder.rs GenericUltraCircuitBuilder<P, T>): with the default
    plain driver, variable values are ints mod r (PlainAcvmSolver); with
    the Rep3 VM driver, values are replicated shares and every product /
    decomposition / sort the builder performs to synthesize intermediate
    witnesses runs as an MPC round — the witness never leaves the share
    domain (the reference's co-builder, co-builder/src/ultra_builder.rs).
    Gate STRUCTURE (indices, selectors, tags) is value-independent, so all
    parties deterministically build identical traces."""

    def __init__(self, driver=None):
        if driver is None:
            from ..ff.spec import BN254_FR
            from ..vm.interp import PlainDriver

            driver = PlainDriver(BN254_FR)
        assert driver.p == R, "builder driver must be over the bn254 fr"
        self.d = driver
        self.variables: list[int] = []
        self.next_var_index: list[int] = []
        self.prev_var_index: list[int] = []
        self.real_variable_index: list[int] = []
        self.real_variable_tags: list[int] = []
        self.public_inputs: list[int] = []
        self.tau: dict[int, int] = {DUMMY_TAG: DUMMY_TAG}
        self.constant_variable_indices: dict[int, int] = {}
        self.zero_idx = 0
        self.one_idx = 1
        self.blocks = {name: TraceBlock(is_pub_inputs=(name == "pub_inputs"),
                                        has_ram_rom=(name == "memory"))
                       for name in BLOCK_ORDER}
        self.num_gates = 0
        self.circuit_finalized = False
        self.lookup_tables: list = []  # BasicTable
        self.range_lists: dict[int, RangeList] = {}
        self.current_tag = 0
        self.memory_read_records: list[int] = []
        self.memory_write_records: list[int] = []
        self.rom_arrays: list = []
        self.ram_arrays: list = []

    # -- variables ----------------------------------------------------------
    def add_variable(self, value) -> int:
        idx = len(self.variables)
        self.variables.append(self.d.norm(value))
        self.real_variable_index.append(idx)
        self.next_var_index.append(REAL_VARIABLE)
        self.prev_var_index.append(FIRST_IN_CLASS)
        self.real_variable_tags.append(DUMMY_TAG)
        return idx

    def get_variable(self, idx: int) -> int:
        return self.variables[self.real_variable_index[idx]]

    def add_public_variable(self, value: int) -> int:
        idx = self.add_variable(value)
        self.public_inputs.append(idx)
        return idx

    def put_constant_variable(self, value: int) -> int:
        if self.d.is_shared(value):
            raise ValueError("constants must be public")
        value = int(value) % R
        if value in self.constant_variable_indices:
            return self.constant_variable_indices[value]
        idx = self.add_variable(value)
        self.fix_witness(idx, value)
        self.constant_variable_indices[value] = idx
        return idx

    def assert_equal(self, a_idx: int, b_idx: int):
        """Merge copy-constraint equivalence classes (ultra_builder.rs:1134)."""
        a_real = self.real_variable_index[a_idx]
        b_real = self.real_variable_index[b_idx]
        if a_real == b_real:
            return
        b_start = b_idx
        while self.prev_var_index[b_start] != FIRST_IN_CLASS:
            b_start = self.prev_var_index[b_start]
        cur = b_start
        while cur != REAL_VARIABLE:
            self.real_variable_index[cur] = a_real
            cur = self.next_var_index[cur]
        a_start = a_idx
        while self.prev_var_index[a_start] != FIRST_IN_CLASS:
            a_start = self.prev_var_index[a_start]
        self.next_var_index[b_real] = a_start
        self.prev_var_index[a_start] = b_real
        ta, tb = self.real_variable_tags[a_real], self.real_variable_tags[b_real]
        assert ta == DUMMY_TAG or tb == DUMMY_TAG or ta == tb, "tag clash"
        if ta == DUMMY_TAG:
            self.real_variable_tags[a_real] = tb

    def assign_tag(self, variable_index: int, tag: int):
        real = self.real_variable_index[variable_index]
        if self.real_variable_tags[real] == tag:
            return
        assert self.real_variable_tags[real] == DUMMY_TAG, "tag clash"
        self.real_variable_tags[real] = tag

    def create_tag(self, tag_index: int, tau_index: int) -> int:
        self.tau[tag_index] = tau_index
        self.current_tag += 1
        return self.current_tag

    def get_new_tag(self) -> int:
        self.current_tag += 1
        return self.current_tag

    # -- gates ---------------------------------------------------------------
    def _arith_gate(self, wires, **sel):
        blk = self.blocks["arithmetic"]
        blk.populate_wires(*wires)
        blk.push_selectors(**sel)
        self.num_gates += 1

    def fix_witness(self, witness_index: int, value: int):
        self._arith_gate((witness_index, self.zero_idx, self.zero_idx,
                          self.zero_idx),
                         q_l=1, q_c=-value % R, q_arith=1)

    def create_poly_gate(self, a, b, c, q_m, q_l, q_r, q_o, q_c):
        self._arith_gate((a, b, c, self.zero_idx), q_m=q_m, q_l=q_l, q_r=q_r,
                         q_o=q_o, q_c=q_c, q_arith=1)

    def create_big_mul_add_gate(self, g: MulQuad, include_next_gate_w_4=False):
        self._arith_gate(
            (g.a, g.b, g.c, g.d),
            q_m=(g.mul_scaling * 2 if include_next_gate_w_4
                 else g.mul_scaling),
            q_l=g.a_scaling, q_r=g.b_scaling, q_o=g.c_scaling,
            q_4=g.d_scaling, q_c=g.const_scaling,
            q_arith=2 if include_next_gate_w_4 else 1)

    def create_big_add_gate(self, a, b, c, d, a_s, b_s, c_s, d_s, const_s,
                            include_next_gate_w_4=False):
        self._arith_gate((a, b, c, d), q_l=a_s, q_r=b_s, q_o=c_s, q_4=d_s,
                         q_c=const_s,
                         q_arith=2 if include_next_gate_w_4 else 1)

    def create_unconstrained_gate(self, block_name, a, b, c, d):
        blk = self.blocks[block_name]
        blk.populate_wires(a, b, c, d)
        blk.push_selectors()
        self.num_gates += 1

    def create_bool_gate(self, idx: int):
        """x^2 - x = 0 (ultra_builder.rs create_bool_gate)."""
        self._arith_gate((idx, idx, self.zero_idx, self.zero_idx),
                         q_m=1, q_l=-1 % R, q_arith=1)

    def _set_zero_idx(self, g: MulQuad):
        assert g.a != IS_CONSTANT, "mul_quad with constant witness a"
        for attr in ("b", "c", "d"):
            if getattr(g, attr) == IS_CONSTANT:
                assert getattr(g, attr + "_scaling") % R == 0
                setattr(g, attr, self.zero_idx)

    def create_quad_constraint(self, g: MulQuad):
        g = dataclasses.replace(g)
        self._set_zero_idx(g)
        self.create_big_mul_add_gate(g, False)

    def create_big_quad_constraint(self, gates: list[MulQuad]):
        gates = [dataclasses.replace(g) for g in gates]
        num_products = len(gates) - 1
        d = self.d
        for j in range(num_products):
            g = gates[j]
            assert g.a != IS_CONSTANT
            if g.b == IS_CONSTANT:
                assert g.b_scaling % R == 0
                g.b = self.zero_idx
            for attr in ("c", "d"):
                if getattr(g, attr) == IS_CONSTANT:
                    assert getattr(g, attr + "_scaling") % R == 0
                    setattr(g, attr, self.zero_idx)
            self.create_big_mul_add_gate(g, True)
            prod = d.mul(self.get_variable(g.a), self.get_variable(g.b))
            nxt = d.add(
                d.add(
                    d.add(g.const_scaling, d.mul(g.mul_scaling, prod)),
                    d.add(d.mul(g.a_scaling, self.get_variable(g.a)),
                          d.mul(g.b_scaling, self.get_variable(g.b))),
                ),
                d.add(d.mul(g.c_scaling, self.get_variable(g.c)),
                      d.mul(g.d_scaling, self.get_variable(g.d))),
            )
            next_idx = self.add_variable(d.neg(nxt))
            gates[j + 1].d = next_idx
            gates[j + 1].d_scaling = -1 % R
        last = gates[-1]
        self._set_zero_idx(last)
        self.create_big_mul_add_gate(last, False)

    # -- public inputs -------------------------------------------------------
    def add_default_to_public_inputs(self):
        """Default (zero) pairing-point accumulator: 8 fixed-zero public
        inputs (ultra_builder.rs:1034-1042)."""
        for _ in range(PUBLIC_INPUTS_SIZE):
            idx = self.add_public_variable(0)
            self.fix_witness(idx, 0)

    def populate_public_inputs_block(self):
        blk = self.blocks["pub_inputs"]
        for idx in self.public_inputs:
            blk.populate_wires(idx, idx, self.zero_idx, self.zero_idx)
            blk.push_selectors()

    # -- sizes ---------------------------------------------------------------
    def get_tables_size(self) -> int:
        return sum(len(t.column_1) for t in self.lookup_tables)

    def get_lookups_size(self) -> int:
        return sum(len(t.lookup_gates) for t in self.lookup_tables)

    def get_total_content_size(self) -> int:
        return sum(len(b) for b in self.blocks.values())

    def compute_dyadic_size(self) -> int:
        total = (NUM_DISABLED_ROWS_IN_SUMCHECK + 1
                 + max(self.get_tables_size(), self.get_total_content_size()))
        size = 1
        while size < total:
            size *= 2
        return size

    def compute_offsets(self):
        offset = 1  # row 0 is the zero row
        for name in BLOCK_ORDER:
            self.blocks[name].trace_offset = offset
            offset += len(self.blocks[name])

    # -- construction entry --------------------------------------------------
    @classmethod
    def create_circuit(cls, af: AcirFormat, witness: list,
                       driver=None) -> "UltraBuilder":
        """Build the trace from ACIR + witness values. With `driver` set
        to a Rep3 VM driver, `witness` entries may be replicated shares
        and the build runs as MPC (the reference's co-builder
        create_circuit, co-builder/src/lib.rs:4040)."""
        if af.unsupported:
            raise NotImplementedError(
                f"ACIR features not yet supported by the builder: "
                f"{sorted(set(af.unsupported))}")
        b = cls(driver)
        witness = list(witness) + [0] * (af.max_witness_index + 1 - len(witness))
        for w in witness:
            b.add_variable(w)
        b.public_inputs = list(af.public_inputs)
        b.zero_idx = b.put_constant_variable(0)
        b.build_constraints(af)
        b.finalize_circuit(ensure_nonzero=True)
        return b

    def build_constraints(self, af: AcirFormat):
        from . import builder_gadgets as gg

        for g in af.quad_constraints:
            self.create_quad_constraint(g)
        for gates in af.big_quad_constraints:
            self.create_big_quad_constraint(gates)
        for lc in af.logic_constraints:
            gg.create_logic_constraint(self, lc)
        for rc in af.range_constraints:
            gg.create_range_constraint(self, rc.witness, rc.num_bits)
        for pc in af.poseidon2_constraints:
            gg.create_poseidon2_permutation(self, pc)
        for bc in af.block_constraints:
            gg.create_block_constraint(self, bc)
        self.add_default_to_public_inputs()

    def finalize_circuit(self, ensure_nonzero=True):
        from . import builder_gadgets as gg

        if self.circuit_finalized:
            return
        if ensure_nonzero:
            gg.add_gates_to_ensure_all_polys_are_non_zero(self)
        gg.process_rom_arrays(self)
        gg.process_ram_arrays(self)
        gg.process_range_lists(self)
        self.populate_public_inputs_block()
        self.circuit_finalized = True
