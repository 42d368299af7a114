"""Port of `cosnarks_tpu.honk.builder_gadgets`: host Python, copied unchanged.

Builder gate gadgets: plookup tables, ensure-nonzero gates, range /
logic / poseidon2 / ROM-RAM constraint lowering.

Split out of builder.py; mirrors ultra_builder.rs:4964-5400
(add_gates_to_ensure_all_polys_are_non_zero), types/plookup.rs (basic /
multi tables), and the per-constraint creation paths. Staged: this file
starts with what the arithmetic-only circuits need (the Honk dummy
lookup that guarantees non-zero lookup polynomials) plus plookup-backed
range/logic gadgets; remaining gadget families raise until implemented.
"""

from __future__ import annotations

import dataclasses

from .builder import R, UltraBuilder

HONK_DUMMY_BASIC1_ID = 95
HONK_DUMMY_BASIC2_ID = 96


@dataclasses.dataclass
class BasicTable:
    """types/plookup.rs PlookupBasicTable."""
    id: object
    table_index: int
    use_twin_keys: bool
    column_1: list
    column_2: list
    column_3: list
    column_1_step_size: int = 0
    column_2_step_size: int = 0
    column_3_step_size: int = 0
    lookup_gates: list = dataclasses.field(default_factory=list)  # [(k0, k1)]
    index_map: dict = dataclasses.field(default_factory=dict)

    def __len__(self):
        return len(self.column_1)


def generate_honk_dummy_table(table_id, bb_id: int, table_index: int) -> BasicTable:
    """plookup.rs generate_honk_dummy_table: 2-bit twin-key table with
    column_3 = 3i + 4j + bb_id * 0x1337."""
    c1, c2, c3 = [], [], []
    for i in range(2):
        for j in range(2):
            c1.append(i)
            c2.append(j)
            c3.append((i * 3 + j * 4 + bb_id * 0x1337) % R)
    return BasicTable(id=table_id, table_index=table_index, use_twin_keys=True,
                      column_1=c1, column_2=c2, column_3=c3,
                      column_1_step_size=2, column_2_step_size=2,
                      column_3_step_size=2)


def generate_logic_table(table_id, op, bits: int, table_index: int) -> BasicTable:
    """plookup.rs generate_{and,xor}_rotate_table (rotation 0)."""
    base = 1 << bits
    c1, c2, c3 = [], [], []
    for i in range(base):
        for j in range(base):
            c1.append(i)
            c2.append(j)
            c3.append(op(i, j))
    return BasicTable(id=table_id, table_index=table_index, use_twin_keys=True,
                      column_1=c1, column_2=c2, column_3=c3,
                      column_1_step_size=base, column_2_step_size=base,
                      column_3_step_size=base)


# registry: table id -> constructor(table_index) (plookup.rs create_basic_table)
BASIC_TABLES = {
    "honk_dummy_basic1": lambda idx: generate_honk_dummy_table(
        "honk_dummy_basic1", HONK_DUMMY_BASIC1_ID, idx),
    "honk_dummy_basic2": lambda idx: generate_honk_dummy_table(
        "honk_dummy_basic2", HONK_DUMMY_BASIC2_ID, idx),
    "uint_xor_slice6": lambda idx: generate_logic_table(
        "uint_xor_slice6", lambda a, b: a ^ b, 6, idx),
    "uint_xor_slice2": lambda idx: generate_logic_table(
        "uint_xor_slice2", lambda a, b: a ^ b, 2, idx),
    "uint_and_slice6": lambda idx: generate_logic_table(
        "uint_and_slice6", lambda a, b: a & b, 6, idx),
    "uint_and_slice2": lambda idx: generate_logic_table(
        "uint_and_slice2", lambda a, b: a & b, 2, idx),
}


def get_table(builder: UltraBuilder, table_id) -> BasicTable:
    for t in builder.lookup_tables:
        if t.id == table_id:
            return t
    t = BASIC_TABLES[table_id](len(builder.lookup_tables))
    builder.lookup_tables.append(t)
    return t


@dataclasses.dataclass
class MultiTable:
    """plookup.rs PlookupMultiTable (public metadata only)."""
    id: object
    basic_table_ids: list
    slice_sizes: list  # per-lookup base
    column_1_step_sizes: list
    column_2_step_sizes: list
    column_3_step_sizes: list
    get_table_values: list  # [(k0, k1) -> (v0, v1)]


def _honk_dummy_multi() -> MultiTable:
    # coefficients 1, 2, 4 -> step sizes [1, 2] (plookup.rs:501-524)
    def val1(k):
        return ((k[0] * 3 + k[1] * 4 + HONK_DUMMY_BASIC1_ID * 0x1337) % R, 0)

    def val2(k):
        return ((k[0] * 3 + k[1] * 4 + HONK_DUMMY_BASIC2_ID * 0x1337) % R, 0)

    return MultiTable(id="honk_dummy_multi",
                      basic_table_ids=["honk_dummy_basic1",
                                       "honk_dummy_basic2"],
                      slice_sizes=[2, 2],
                      column_1_step_sizes=[1, 2],
                      column_2_step_sizes=[1, 2],
                      column_3_step_sizes=[1, 2],
                      get_table_values=[val1, val2])


def _uint32_logic_multi(is_xor: bool) -> MultiTable:
    """plookup.rs get_uint_{xor,and}_table::<32>: five 6-bit slices plus a
    2-bit tail, coefficients 64^i."""
    name = "xor" if is_xor else "and"
    op = (lambda k: ((k[0] ^ k[1]), 0)) if is_xor else (lambda k: ((k[0] & k[1]), 0))
    num_entries = 32 // 6  # 5
    coeff = [pow(64, i, R) for i in range(num_entries + 1)]
    steps = [1] + [64] * num_entries
    return MultiTable(id=f"uint32_{name}",
                      basic_table_ids=[f"uint_{name}_slice6"] * num_entries
                      + [f"uint_{name}_slice2"],
                      slice_sizes=[64] * num_entries + [4],
                      column_1_step_sizes=list(steps),
                      column_2_step_sizes=list(steps),
                      column_3_step_sizes=list(steps),
                      get_table_values=[op] * (num_entries + 1))


MULTI_TABLES = {
    "honk_dummy_multi": _honk_dummy_multi,
    "uint32_xor": lambda: _uint32_logic_multi(True),
    "uint32_and": lambda: _uint32_logic_multi(False),
}


def slice_input(value: int, bases: list[int]) -> list[int]:
    """plookup.rs slice_input_using_variable_bases."""
    out = []
    for base in bases:
        out.append(value % base)
        value //= base
    return out


def get_lookup_accumulators(builder: UltraBuilder, multi: MultiTable,
                            key_a: int, key_b: int, is_2_to_1: bool):
    """plookup.rs get_lookup_accumulators (plain): returns (columns[3],
    lookup_entries) where columns hold the accumulating sums."""
    n = len(multi.basic_table_ids)
    a_slices = slice_input(key_a, multi.slice_sizes)
    b_slices = slice_input(key_b, multi.slice_sizes)
    values = [multi.get_table_values[i]((a_slices[i], b_slices[i]))
              for i in range(n)]
    c1_raw = list(a_slices)
    if is_2_to_1:
        c2_raw = list(b_slices)
        c3_raw = [v[0] for v in values]
    else:
        c2_raw = [v[0] for v in values]
        c3_raw = [v[1] for v in values]
    entries = [(a_slices[i], b_slices[i]) for i in range(n)]
    c1, c2, c3 = [0] * n, [0] * n, [0] * n
    c1[n - 1], c2[n - 1], c3[n - 1] = c1_raw[n - 1], c2_raw[n - 1], c3_raw[n - 1]
    for i in range(n - 1, 0, -1):
        c1[i - 1] = (c1_raw[i - 1] + multi.column_1_step_sizes[i] * c1[i]) % R
        c2[i - 1] = (c2_raw[i - 1] + multi.column_2_step_sizes[i] * c2[i]) % R
        c3[i - 1] = (c3_raw[i - 1] + multi.column_3_step_sizes[i] * c3[i]) % R
    return (c1, c2, c3), entries


def create_gates_from_plookup_accumulators(builder: UltraBuilder,
                                           multi: MultiTable, columns,
                                           entries,
                                           key_a_index: int,
                                           key_b_index: int | None):
    """ultra_builder.rs create_gates_from_plookup_accumulators. Returns
    the per-row (c1, c2, c3) wire indices."""
    c1, c2, c3 = columns
    n = len(c1)
    read_data = ([], [], [])
    blk = builder.blocks["lookup"]
    for i in range(n):
        first, last = i == 0, i == n - 1
        table = get_table(builder, multi.basic_table_ids[i])
        first_idx = (key_a_index if first
                     else builder.add_variable(c1[i]))
        second_idx = (key_b_index if (first and key_b_index is not None)
                      else builder.add_variable(c2[i]))
        third_idx = builder.add_variable(c3[i])
        table.lookup_gates.append(entries[i])
        read_data[0].append(first_idx)
        read_data[1].append(second_idx)
        read_data[2].append(third_idx)
        if last:
            s1 = s2 = s3 = 0
        else:
            s1 = -multi.column_1_step_sizes[i + 1] % R
            s2 = -multi.column_2_step_sizes[i + 1] % R
            s3 = -multi.column_3_step_sizes[i + 1] % R
        blk.populate_wires(first_idx, second_idx, third_idx, builder.zero_idx)
        blk.push_selectors(q_lookup=1, q_o=table.table_index, q_r=s1,
                           q_m=s2, q_c=s3)
        builder.num_gates += 1
    return read_data


def plookup_read_pair(builder: UltraBuilder, multi_id: str, key_a_index: int,
                      key_b_index: int | None = None,
                      is_2_to_1: bool = True):
    """Convenience: run a full multitable lookup on witness keys; returns
    per-row wire index columns."""
    multi = MULTI_TABLES[multi_id]()
    key_a = builder.get_variable(key_a_index)
    key_b = builder.get_variable(key_b_index) if key_b_index is not None else 0
    if builder.d.is_shared(key_a) or builder.d.is_shared(key_b):
        raise NotImplementedError(
            "plookup on shared keys needs the OHV-LUT read path (staged; "
            "reference co-builder/src/types/plookup.rs)")
    columns, entries = get_lookup_accumulators(builder, multi, key_a, key_b,
                                               is_2_to_1)
    return create_gates_from_plookup_accumulators(
        builder, multi, columns, entries, key_a_index, key_b_index)


def add_gates_to_ensure_all_polys_are_non_zero(builder: UltraBuilder):
    """ultra_builder.rs:4964-5400."""
    b = builder
    # arithmetic selectors nonzero
    b._arith_gate((b.zero_idx,) * 4, q_m=1, q_l=1, q_r=1, q_o=1, q_4=1)
    # one gate + trailing unconstrained gate per remaining selector block
    for name, sel in (("delta_range", "q_delta_range"),
                      ("elliptic", "q_elliptic"),
                      ("memory", "q_memory"),
                      ("nnf", "q_nnf")):
        blk = b.blocks[name]
        blk.populate_wires(*(b.zero_idx,) * 4)
        blk.push_selectors(**{sel: 1})
        b.num_gates += 1
        b.create_unconstrained_gate(name, *(b.zero_idx,) * 4)
    # nonzero w_4 and q_c: q_4*w_4 + q_c = 1*1 - 1 = 0
    b.one_idx = b.put_constant_variable(1)
    b.create_big_add_gate(b.zero_idx, b.zero_idx, b.zero_idx, b.one_idx,
                          0, 0, 0, 1, -1 % R)
    # dummy plookup to make q_lookup/tables/counts nonzero
    left = b.add_variable(3)
    right = b.add_variable(3)
    plookup_read_pair(b, "honk_dummy_multi", left, right, is_2_to_1=True)
    # mock poseidon external + internal gates, each with a trailing
    # unconstrained row read via shifts
    for name, sel in (("pos_ext", "q_pos_ext"), ("pos_int", "q_pos_int")):
        blk = b.blocks[name]
        blk.populate_wires(*(b.zero_idx,) * 4)
        blk.push_selectors(**{sel: 1})
        b.num_gates += 1
        b.create_unconstrained_gate(name, *(b.zero_idx,) * 4)


UNINIT = (1 << 32) - 1  # UNINITIALIZED_MEMORY_RECORD


@dataclasses.dataclass
class RomRecord:
    """rom_ram.rs RomRecord."""
    index_witness: int
    v1_witness: int
    v2_witness: int
    index: int
    record_witness: int = 0
    gate_index: int = 0


@dataclasses.dataclass
class RomTranscript:
    state: list  # [[v1_witness, v2_witness]]
    records: list


def create_rom_array(builder: UltraBuilder, size: int) -> int:
    builder.rom_arrays.append(
        RomTranscript(state=[[UNINIT, UNINIT] for _ in range(size)],
                      records=[]))
    return len(builder.rom_arrays) - 1


def _memory_gate(builder: UltraBuilder, wires, **sel):
    blk = builder.blocks["memory"]
    blk.populate_wires(*wires)
    blk.push_selectors(q_memory=1, **sel)
    builder.num_gates += 1
    return len(blk) - 1


def _create_rom_gate(builder: UltraBuilder, rec: RomRecord, sorted_gate=False):
    """ultra_builder.rs create_rom_gate / create_sorted_rom_gate; memory
    selector patterns from apply_memory_selectors (RomRead: q_1, q_m;
    RomConsistencyCheck: q_1, q_2)."""
    rec.record_witness = builder.add_variable(0)
    wires = (rec.index_witness, rec.v1_witness, rec.v2_witness,
             rec.record_witness)
    if sorted_gate:
        rec.gate_index = _memory_gate(builder, wires, q_l=1, q_r=1)
    else:
        rec.gate_index = _memory_gate(builder, wires, q_l=1, q_m=1)


def set_rom_element(builder: UltraBuilder, rom_id: int, index_value: int,
                    value_witness: int, value2_witness: int | None = None):
    b = builder
    index_witness = (b.zero_idx if index_value == 0
                     else b.put_constant_variable(index_value))
    state = b.rom_arrays[rom_id].state
    assert state[index_value][0] == UNINIT
    v2 = b.zero_idx if value2_witness is None else value2_witness
    rec = RomRecord(index_witness, value_witness, v2, index_value)
    state[index_value][0] = value_witness
    state[index_value][1] = v2
    _create_rom_gate(b, rec)
    b.rom_arrays[rom_id].records.append(rec)


def read_rom_array(builder: UltraBuilder, rom_id: int,
                   index_witness: int) -> int:
    """ultra_builder.rs read_rom_array (plain)."""
    b = builder
    idx = b.get_variable(index_witness)
    if b.d.is_shared(idx):
        raise NotImplementedError(
            "ROM reads at shared indices need the OHV-LUT gadget in the "
            "builder (staged; rom_ram.rs shared path)")
    idx = int(idx)
    state = b.rom_arrays[rom_id].state
    assert idx < len(state) and state[idx][0] != UNINIT
    value = b.get_variable(state[idx][0])
    value_witness = b.add_variable(value)
    rec = RomRecord(index_witness, value_witness, b.zero_idx, idx)
    _create_rom_gate(b, rec)
    b.rom_arrays[rom_id].records.append(rec)
    return value_witness


def process_rom_arrays(builder: UltraBuilder):
    """ultra_builder.rs process_rom_array(+_public_inner): sorted read
    transcript with tag-based set equivalence + max-index bound gate."""
    b = builder
    for rom_id in range(len(b.rom_arrays)):
        read_tag = b.get_new_tag()
        sorted_tag = b.get_new_tag()
        b.create_tag(read_tag, sorted_tag)
        b.create_tag(sorted_tag, read_tag)
        arr = b.rom_arrays[rom_id]
        for i, st in enumerate(arr.state):
            if st[0] == UNINIT:
                set_rom_element(b, rom_id, i, b.zero_idx, b.zero_idx)
        for rec in sorted(arr.records, key=lambda r: r.index):
            v1 = b.get_variable(rec.v1_witness)
            v2 = b.get_variable(rec.v2_witness)
            srec = RomRecord(b.add_variable(rec.index),
                             b.add_variable(v1), b.add_variable(v2),
                             rec.index)
            _create_rom_gate(b, srec, sorted_gate=True)
            b.assign_tag(rec.record_witness, read_tag)
            b.assign_tag(srec.record_witness, sorted_tag)
            b.memory_read_records.append(srec.gate_index)
            b.memory_read_records.append(rec.gate_index)
        max_index_value = len(arr.state)
        max_index = b.add_variable(max_index_value)
        b.create_unconstrained_gate("memory", max_index, b.zero_idx,
                                    b.zero_idx, b.zero_idx)
        b.create_big_add_gate(max_index, b.zero_idx, b.zero_idx, b.zero_idx,
                              1, 0, 0, 0, -max_index_value % R)


def process_ram_arrays(builder: UltraBuilder):
    if builder.ram_arrays:
        raise NotImplementedError("RAM arrays not yet implemented")


def _sorted_values(builder, vals, bits):
    """Ascending sort of range-list values: python sort when everything is
    public, the oblivious radix sort over share values otherwise (the
    reference routes this through the rep3_ring sort gadget when building
    from a shared witness)."""
    d = builder.d
    if not any(d.is_shared(v) for v in vals):
        return sorted(int(v) for v in vals)
    from ..mpc.rep3_ring import Rep3Ring, radix_sort_fields

    ring = getattr(builder, "_sort_ring", None)
    if ring is None:
        ring = Rep3Ring(d.pr.net, d.pr.rng, 32)
        builder._sort_ring = ring
    priv = [d.to_share(v) for v in vals]
    return radix_sort_fields(d.pr, ring, priv, [], bits)


def process_range_lists(builder: UltraBuilder):
    """ultra_builder.rs process_range_lists + process_range_list (plain):
    sort each range list's values, tag the sorted copies with tau, and
    emit delta-range sort constraints with edges 0..target_range."""
    from .builder import RangeList  # noqa: F401 (type reference)

    for target_range in sorted(builder.range_lists):
        lst = builder.range_lists[target_range]
        idxs = sorted({builder.real_variable_index[i]
                       for i in lst.variable_indices})
        sorted_vals = _sorted_values(
            builder, [builder.variables[i] for i in idxs],
            max(1, lst.target_range.bit_length()))
        padding = (4 - (len(idxs) % 4)) % 4
        if len(idxs) <= 4:
            padding += 4
        indices = [builder.zero_idx] * padding
        for v in sorted_vals:
            idx = builder.add_variable(v)
            builder.assign_tag(idx, lst.tau_tag)
            indices.append(idx)
        create_sort_constraint_with_edges(builder, indices, 0,
                                          lst.target_range)


def create_sort_constraint_with_edges(builder: UltraBuilder, indices, start,
                                      end):
    """ultra_builder.rs:3188-3337."""
    b = builder
    assert len(indices) % 4 == 0 and len(indices) > 4
    b.create_big_add_gate(indices[0], b.zero_idx, b.zero_idx, b.zero_idx,
                          1, 0, 0, 0, -start % R)
    blk = b.blocks["delta_range"]
    for i in range(0, len(indices) - 4, 4):
        blk.populate_wires(indices[i], indices[i + 1], indices[i + 2],
                           indices[i + 3])
        blk.push_selectors(q_delta_range=1)
        b.num_gates += 1
    blk.populate_wires(indices[-4], indices[-3], indices[-2], indices[-1])
    blk.push_selectors(q_delta_range=1)
    b.num_gates += 1
    b.create_unconstrained_gate("delta_range", indices[-1], b.zero_idx,
                                b.zero_idx, b.zero_idx)
    b.create_big_add_gate(indices[-1], b.zero_idx, b.zero_idx, b.zero_idx,
                          1, 0, 0, 0, -end % R)


def create_dummy_constraints(builder: UltraBuilder, indices):
    """Unconstrained gates that place variables in the trace
    (ultra_builder.rs:3164-3186)."""
    padded = list(indices)
    while len(padded) % 4:
        padded.append(builder.zero_idx)
    for i in range(0, len(padded), 4):
        builder.create_unconstrained_gate("arithmetic", *padded[i:i + 4])


def create_range_list(builder: UltraBuilder, target_range: int):
    """ultra_builder.rs:3135-3162: seed the list with multiples of the
    step size plus the endpoint, tagged with a fresh range tag."""
    from .builder import DEFAULT_PLOOKUP_RANGE_STEP_SIZE, RangeList

    b = builder
    range_tag = b.get_new_tag()
    tau_tag = b.get_new_tag()
    b.create_tag(range_tag, tau_tag)
    b.create_tag(tau_tag, range_tag)
    step = DEFAULT_PLOOKUP_RANGE_STEP_SIZE
    variable_indices = []
    for i in range(target_range // step + 1):
        idx = b.add_variable(i * step)
        variable_indices.append(idx)
        b.assign_tag(idx, range_tag)
    idx = b.add_variable(target_range)
    variable_indices.append(idx)
    b.assign_tag(idx, range_tag)
    create_dummy_constraints(b, variable_indices)
    return RangeList(target_range=target_range, range_tag=range_tag,
                     tau_tag=tau_tag, variable_indices=variable_indices)


def create_new_range_constraint(builder: UltraBuilder, variable_index: int,
                                target_range: int):
    """ultra_builder.rs create_new_range_constraint."""
    b = builder
    if target_range not in b.range_lists:
        b.range_lists[target_range] = create_range_list(b, target_range)
    lst = b.range_lists[target_range]
    existing = b.real_variable_tags[b.real_variable_index[variable_index]]
    if existing == lst.range_tag:
        return
    if existing != 0:  # DUMMY_TAG
        for rng in b.range_lists:
            if b.range_lists[rng].range_tag == existing:
                if rng < target_range:
                    return  # already more restrictive
                copied = b.add_variable(b.get_variable(variable_index))
                b.create_big_add_gate(variable_index, copied, b.zero_idx,
                                      b.zero_idx, 1, -1 % R, 0, 0, 0)
                create_new_range_constraint(b, copied, target_range)
                return
        raise AssertionError("variable tagged with unknown range tag")
    b.assign_tag(variable_index, lst.range_tag)
    lst.variable_indices.append(variable_index)


def create_range_constraint(builder: UltraBuilder, witness: int, bits: int):
    """build_constraints range path + create_dyadic_range_constraint
    (ultra_builder.rs:2640-2672), plain driver."""
    from .builder import DEFAULT_PLOOKUP_RANGE_BITNUM

    b = builder
    if bits == 1:
        b.create_bool_gate(witness)
    elif bits <= DEFAULT_PLOOKUP_RANGE_BITNUM:
        b.create_unconstrained_gate("arithmetic", witness, b.zero_idx,
                                    b.zero_idx, b.zero_idx)
        create_new_range_constraint(b, witness, (1 << bits) - 1)
    else:
        create_limbed_range_constraint(b, witness, bits,
                                       DEFAULT_PLOOKUP_RANGE_BITNUM)


def create_limbed_range_constraint(builder: UltraBuilder, variable_index: int,
                                   num_bits: int, limb_bits: int):
    """ultra_builder.rs:2726-2899 (plain): decompose into limb_bits-wide
    sublimbs, range-check each, and tie them to the original value with
    w4-chained big-add gates."""
    b = builder
    val = b.get_variable(variable_index)
    sublimb_mask = (1 << limb_bits) - 1
    has_rem = num_bits % limb_bits != 0
    num_limbs = num_bits // limb_bits + (1 if has_rem else 0)
    last_limb_range = (1 << (num_bits % limb_bits)) - 1

    sublimbs = []
    if b.d.is_shared(val):
        # shared decompose: one binary decomposition (A2B + bit-inject),
        # limbs recomposed locally (co-builder decompose over T::AcvmType)
        bits = b.d.num2bits(val, num_bits)
        for i in range(num_limbs):
            limb = 0
            for k in range(limb_bits):
                j = i * limb_bits + k
                if j < num_bits:
                    limb = b.d.add(limb, b.d.mul(1 << k, bits[j]))
            sublimbs.append(limb)
    else:
        acc = val
        for _ in range(num_limbs):
            sublimbs.append(acc & sublimb_mask)
            acc >>= limb_bits
    sublimb_indices = []
    for i, s in enumerate(sublimbs):
        idx = b.add_variable(s)
        sublimb_indices.append(idx)
        if i == num_limbs - 1 and has_rem:
            create_new_range_constraint(b, idx, last_limb_range)
        else:
            create_new_range_constraint(b, idx, sublimb_mask)

    num_triples = (num_limbs + 2) // 3
    leftovers = 3 if num_limbs % 3 == 0 else num_limbs % 3
    accumulator_idx = variable_index
    accumulator = val
    for i in range(num_triples):
        real = [not (i == num_triples - 1 and leftovers < k)
                for k in (1, 2, 3)]
        limbs = [sublimb_indices[3 * i + k] if real[k] else b.zero_idx
                 for k in range(3)]
        vals = [sublimbs[3 * i + k] if real[k] else 0 for k in range(3)]
        shifts = [pow(2, limb_bits * (3 * i + k), R) if limb_bits * (3 * i + k) < 256
                  else 0 for k in range(3)]
        d = b.d
        subtrahend = d.add(d.add(d.mul(shifts[0], vals[0]),
                                 d.mul(shifts[1], vals[1])),
                           d.mul(shifts[2], vals[2]))
        new_acc = d.sub(accumulator, subtrahend)
        b.create_big_add_gate(limbs[0], limbs[1], limbs[2], accumulator_idx,
                              shifts[0], shifts[1], shifts[2], -1 % R, 0,
                              include_next_gate_w_4=(i != num_triples - 1))
        if i != num_triples - 1:
            accumulator_idx = b.add_variable(new_acc)
            accumulator = new_acc
    return sublimb_indices


def create_logic_constraint(builder: UltraBuilder, lc):
    """AND/XOR blackbox -> 32-bit-chunked uint plookup reads
    (ultra_builder.rs create_logic_gate / create_logic_constraint_inner)."""
    from .field_ct import FieldCT

    b = builder
    a = FieldCT.from_woc(lc.a)
    bb = FieldCT.from_woc(lc.b)
    res = _logic_inner(b, a, bb, lc.num_bits, lc.is_xor)
    res.assert_equal(FieldCT.from_witness_index(lc.result), b)


def _logic_inner(b, a, bb, num_bits: int, is_xor: bool):
    from .field_ct import FieldCT

    assert 0 < num_bits < 254
    if b.d.is_shared(a.get_value(b)) or b.d.is_shared(bb.get_value(b)):
        raise NotImplementedError(
            "logic gates on shared witnesses need shared plookup (staged)")
    op = (lambda x, y: x ^ y) if is_xor else (lambda x, y: x & y)
    if a.is_constant() and bb.is_constant():
        av, bv = a.get_value(b), bb.get_value(b)
        assert av < (1 << num_bits) and bv < (1 << num_bits)
        return FieldCT.from_constant(op(av, bv))
    if a.is_constant():
        a = FieldCT.from_witness_index(b.put_constant_variable(a.get_value(b)))
    if bb.is_constant():
        bb = FieldCT.from_witness_index(
            b.put_constant_variable(bb.get_value(b)))

    num_chunks = (num_bits + 31) // 32
    left, right = a.get_value(b), bb.get_value(b)
    mask = (1 << 32) - 1
    a_acc = FieldCT.from_constant(0)
    b_acc = FieldCT.from_constant(0)
    res = FieldCT.from_constant(0)
    multi_id = "uint32_xor" if is_xor else "uint32_and"
    for i in range(num_chunks):
        chunk_size = 32 if i != num_chunks - 1 else num_bits - 32 * i
        a_chunk = FieldCT.from_witness((left >> (32 * i)) & mask, b)
        b_chunk = FieldCT.from_witness((right >> (32 * i)) & mask, b)
        cols = plookup_read_pair(b, multi_id, a_chunk.witness_index,
                                 b_chunk.witness_index, is_2_to_1=True)
        result_chunk = FieldCT.from_witness_index(cols[2][0])
        scaling = FieldCT.from_constant(pow(2, 32 * i, R))
        a_acc = a_acc.add(a_chunk.multiply(scaling, b), b)
        b_acc = b_acc.add(b_chunk.multiply(scaling, b), b)
        if chunk_size != 32:
            create_range_constraint(b, a_chunk.witness_index, chunk_size)
            create_range_constraint(b, b_chunk.witness_index, chunk_size)
        res = res.add(result_chunk.multiply(scaling, b), b)
    a.assert_equal(a_acc, b)
    bb.assert_equal(b_acc, b)
    return res


def create_poseidon2_permutation(builder: UltraBuilder, pc):
    """Poseidon2Permutation blackbox -> poseidon2 external/internal gates
    (co-builder/src/types/poseidon2.rs, ultra_builder.rs:584-720 —
    selectors hold the round constants; each round's output is read from
    the next trace row via shifts)."""
    from ..gadgets.poseidon2_params import PARAMS
    from .field_ct import FieldCT
    from .transcript_driver import driver_matmuls

    prm = PARAMS[4]
    rc_ext = [[v % R for v in rc] for rc in prm["rc_external"]]
    rc_int = [v % R for v in prm["rc_internal"]]
    rounds_f, rounds_p = prm["rounds_f"], prm["rounds_p"]
    b = builder
    state = [FieldCT.from_woc(s) for s in pc.state]
    native = [s.get_value(b) for s in state]

    # initial external matrix multiplication, both native and in-circuit
    # (poseidon2.rs matrix_multiplication_external: 6 gates)
    driver_matmuls.matmul_external(b.d, native)
    two = FieldCT.from_constant(2)
    four = FieldCT.from_constant(4)
    tmp1 = state[0].add_two(state[1], state[3].multiply(two, b), b)
    tmp2 = state[2].add_two(state[1].multiply(two, b), state[3], b)
    state[1] = tmp2.add_two(state[0].multiply(four, b),
                            state[1].multiply(four, b), b)
    state[0] = state[1].add(tmp1, b)
    state[3] = tmp1.add_two(state[2].multiply(four, b),
                            state[3].multiply(four, b), b)
    state[2] = state[3].add(tmp2, b)
    assert all(s.is_normalized() for s in state), \
        "poseidon2 state must not be constant"

    def ext_gate(round_idx):
        blk = b.blocks["pos_ext"]
        blk.populate_wires(*(s.witness_index for s in state))
        blk.push_selectors(q_pos_ext=1, q_l=rc_ext[round_idx][0],
                           q_r=rc_ext[round_idx][1],
                           q_o=rc_ext[round_idx][2],
                           q_4=rc_ext[round_idx][3])
        b.num_gates += 1

    def int_gate(round_idx):
        blk = b.blocks["pos_int"]
        blk.populate_wires(*(s.witness_index for s in state))
        blk.push_selectors(q_pos_int=1, q_l=rc_int[round_idx])
        b.num_gates += 1

    def refresh():
        for i in range(4):
            state[i] = FieldCT.from_witness(native[i], b)

    for r in range(rounds_f // 2):
        ext_gate(r)
        driver_matmuls.external_round(b.d, native, rc_ext[r])
        refresh()
    b.create_unconstrained_gate("pos_ext", *(s.witness_index for s in state))
    for r in range(rounds_p):
        int_gate(r)
        driver_matmuls.internal_round(b.d, native, rc_int[r])
        refresh()
    b.create_unconstrained_gate("pos_int", *(s.witness_index for s in state))
    for r in range(rounds_f // 2, rounds_f):
        ext_gate(r)
        driver_matmuls.external_round(b.d, native, rc_ext[r])
        refresh()
    b.create_unconstrained_gate("pos_ext", *(s.witness_index for s in state))

    for out, res in zip(state, pc.result):
        out.assert_equal(FieldCT.from_witness_index(res), b)


def create_block_constraint(builder: UltraBuilder, bc):
    """MemoryInit/MemoryOp blocks -> ROM table reads (ultra_builder.rs
    create_block_constraints / process_rom_operations + rom_ram.rs
    RomTable). RAM (write) blocks are staged next."""
    from .field_ct import FieldCT

    if bc.type != "ROM":
        raise NotImplementedError(f"{bc.type} memory blocks not yet "
                                  "implemented")
    entries = [FieldCT.from_witness_index(w) for w in bc.init]
    rom_id = None
    for op in bc.trace:
        assert op.access_type == 0
        index = FieldCT.from_woc(op.index)
        value = FieldCT.from_woc(op.value)
        if index.is_constant():
            val = entries[index.get_value(builder)]
        else:
            if rom_id is None:
                # initialize the table lazily (RomTable::initialize_table)
                state = []
                for e in entries:
                    if e.is_constant():
                        state.append(FieldCT.from_witness_index(
                            builder.put_constant_variable(e.get_value(builder))))
                    else:
                        state.append(e)
                entries = state
                rom_id = create_rom_array(builder, len(entries))
                for i, e in enumerate(entries):
                    set_rom_element(builder, rom_id, i,
                                    e.get_witness_index(builder))
            out = read_rom_array(builder, rom_id,
                                 index.get_witness_index(builder))
            val = FieldCT.from_witness_index(out)
        value.assert_equal(val, builder)


# -- read counts / table polynomials (keys/plain_proving_key.rs:342-476) ----

def construct_lookup_table_polynomials(builder: UltraBuilder,
                                       dyadic_size: int):
    """Returns the 4 table columns over the full domain."""
    from .builder import NUM_DISABLED_ROWS_IN_SUMCHECK

    assert dyadic_size > builder.get_tables_size() + NUM_DISABLED_ROWS_IN_SUMCHECK
    cols = [[0] * dyadic_size for _ in range(4)]
    offset = 0
    for table in builder.lookup_tables:
        for i in range(len(table)):
            cols[0][offset] = table.column_1[i] % R
            cols[1][offset] = table.column_2[i] % R
            cols[2][offset] = table.column_3[i] % R
            cols[3][offset] = table.table_index
            offset += 1
    return cols


def construct_lookup_read_counts(builder: UltraBuilder, dyadic_size: int):
    """Returns (read_counts, read_tags) over the full domain."""
    counts = [0] * dyadic_size
    tags = [0] * dyadic_size
    offset = 0
    for table in builder.lookup_tables:
        base = table.column_2_step_size
        for k0, k1 in table.lookup_gates:
            if table.use_twin_keys:
                idx = k0 * base + k1
            else:
                idx = k0
            if table.index_map:
                idx = table.index_map[idx]
            counts[offset + idx] += 1
            tags[offset + idx] = 1
        offset += len(table)
    return counts, tags
