"""Port of `cosnarks_tpu.honk.proving_key`: the key construction is host
Python, copied unchanged; new are `ProvingKey.to_device` and
`device_polys`, which turn the polynomials into (n, 16) Montgomery limb
tensors on the prover's device once, at the prover's boundary.

Proving/verification key construction from a finalized builder.

Mirrors co-builder/src/keys/plain_proving_key.rs: populate the wire and
selector polynomials from the trace blocks, compute copy cycles and the
Honk-style sigma/id permutation polynomials (with the public-input cycle
break and tag/tau handling), Lagrange first/last, lookup table columns and
read counts, and assemble PlainProvingKey + VerifyingKeyBarretenberg.

Entity layout constants follow co-noir-common/src/polynomials/entities.rs.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from . import builder_gadgets, polyops
from .builder import (BLOCK_ORDER, NUM_WIRES, PERMUTATION_SEPARATOR, R,
                      UltraBuilder)

# precomputed entity order (entities.rs:255-311)
PRECOMPUTED = ("q_m", "q_c", "q_l", "q_r", "q_o", "q_4", "q_lookup",
               "q_arith", "q_delta_range", "q_elliptic", "q_memory", "q_nnf",
               "q_pos_ext", "q_pos_int",
               "sigma_1", "sigma_2", "sigma_3", "sigma_4",
               "id_1", "id_2", "id_3", "id_4",
               "table_1", "table_2", "table_3", "table_4",
               "lagrange_first", "lagrange_last")
# prover witness entity order (entities.rs:112-176)
PROVER_WITNESS = ("w_l", "w_r", "w_o", "w_4", "lookup_read_counts",
                  "lookup_read_tags")
# full witness entity order incl. prover-computed columns (entities.rs:635)
WITNESS = ("w_l", "w_r", "w_o", "w_4", "z_perm", "lookup_inverses",
           "lookup_read_counts", "lookup_read_tags")
SHIFTED = ("w_l", "w_r", "w_o", "w_4", "z_perm")

NUM_ALL_ENTITIES = len(WITNESS) + len(PRECOMPUTED) + len(SHIFTED)  # 41


@dataclasses.dataclass
class ActiveRegionData:
    ranges: list  # [(start, end)]
    idxs: list  # flattened indices

    @classmethod
    def new(cls):
        return cls([], [])

    def add_range(self, start, end):
        self.ranges.append((start, end))
        self.idxs.extend(range(start, end))

    def size(self):
        return len(self.idxs)


@dataclasses.dataclass
class ProvingKey:
    circuit_size: int
    log_circuit_size: int
    public_inputs: list
    num_public_inputs: int
    pub_inputs_offset: int
    polynomials: dict  # name -> list[int] or (n, 16) Montgomery limbs
    memory_read_records: list
    memory_write_records: list
    final_active_wire_idx: int
    active_region_data: ActiveRegionData

    @property
    def device(self):
        """The device of the tensor polynomials; None while they are host
        lists."""
        for v in self.polynomials.values():
            if isinstance(v, torch.Tensor):
                return v.device
        return None

    def to_device(self, device=None, names=None) -> "ProvingKey":
        """A copy whose polynomials `names` (default: all) are limb tensors
        on `device`; the others are shared with this key."""
        dev = resolve_device(device)
        polys = dict(self.polynomials)
        for name in (polys if names is None else names):
            v = polys[name]
            polys[name] = (v.to(dev) if isinstance(v, torch.Tensor)
                           else polyops.encode(v, dev))
        return dataclasses.replace(self, polynomials=polys)


def device_polys(pk: ProvingKey, names, device) -> torch.Tensor:
    """The polynomials `names` stacked as one (len(names), n, 16) tensor on
    `device` (tensors are moved, host lists encoded)."""
    cols = []
    for name in names:
        v = pk.polynomials[name]
        cols.append(v.to(device) if isinstance(v, torch.Tensor)
                    else polyops.encode(v, device))
    return torch.stack(cols)


@dataclasses.dataclass
class VerifyingKey:
    """VerifyingKeyBarretenberg (verification_key.rs:77)."""
    log_circuit_size: int
    num_public_inputs: int
    pub_inputs_offset: int
    commitments: list  # 28 affine points in PRECOMPUTED order

    def hash_into_transcript(self, transcript) -> int:
        """hash_with_origin_tagging (verification_key.rs:261-290)."""
        transcript.add_u64_to_independent_hash_buffer(
            "vk_log_circuit_size", self.log_circuit_size)
        transcript.add_u64_to_independent_hash_buffer(
            "vk_num_public_inputs", self.num_public_inputs)
        transcript.add_u64_to_independent_hash_buffer(
            "vk_pub_inputs_offset", self.pub_inputs_offset)
        for c in self.commitments:
            transcript.add_point_to_independent_hash_buffer("vk_commitment", c)
        return transcript.hash_independent_buffer()

    def to_buffer(self, keccak: bool = False) -> bytes:
        """Barretenberg vk serialization (verification_key.rs:115-177):
        3 header field elements + per-commitment coordinates (split into
        two Fr each for the field flavor, one U256 each for keccak)."""
        from .transcript import fq_to_two_fr

        out = bytearray()
        for v in (self.log_circuit_size, self.num_public_inputs,
                  self.pub_inputs_offset):
            out += int(v).to_bytes(32, "big")
        for pt in self.commitments:
            x, y = (0, 0) if pt is None else pt
            if keccak:
                out += int(x).to_bytes(32, "big")
                out += int(y).to_bytes(32, "big")
            else:
                for half in fq_to_two_fr(x) + fq_to_two_fr(y):
                    out += int(half).to_bytes(32, "big")
        return bytes(out)

    @classmethod
    def from_buffer(cls, buf: bytes, keccak: bool = False) -> "VerifyingKey":
        from .transcript import two_fr_to_fq

        words = [int.from_bytes(buf[i:i + 32], "big")
                 for i in range(0, len(buf), 32)]
        log_n, n_pub, offset = words[0], words[1], words[2]
        commitments = []
        pos = 3
        per = 2 if keccak else 4
        while pos + per <= len(words):
            if keccak:
                x, y = words[pos], words[pos + 1]
            else:
                x = two_fr_to_fq(words[pos], words[pos + 1])
                y = two_fr_to_fq(words[pos + 2], words[pos + 3])
            from .transcript import validate_g1

            commitments.append(
                validate_g1(None if x == 0 and y == 0 else (x, y),
                            "vk_commitment"))
            pos += per
        if len(commitments) != len(PRECOMPUTED):
            raise ValueError("bad verification key length")
        return cls(log_n, n_pub, offset, commitments)


def create_proving_key(builder: UltraBuilder) -> ProvingKey:
    assert builder.circuit_finalized
    n = builder.compute_dyadic_size()
    builder.compute_offsets()

    final_active_wire_idx = 0
    for name in BLOCK_ORDER:
        blk = builder.blocks[name]
        if len(blk):
            final_active_wire_idx = blk.trace_offset + len(blk) - 1

    polys = {name: [0] * n for name in PRECOMPUTED + PROVER_WITNESS}

    # memory records (plain_proving_key.rs populate_memory_records)
    mem_off = builder.blocks["memory"].trace_offset
    read_records = [i + mem_off for i in builder.memory_read_records]
    write_records = [i + mem_off for i in builder.memory_write_records]

    # wires + selectors + copy cycles
    active = ActiveRegionData.new()
    copy_cycles = [[] for _ in range(len(builder.variables))]
    wire_names = ("w_l", "w_r", "w_o", "w_4")
    from .builder import SELECTORS

    sel_to_precomputed = dict(zip(SELECTORS, (
        "q_m", "q_c", "q_l", "q_r", "q_o", "q_4", "q_lookup", "q_arith",
        "q_delta_range", "q_elliptic", "q_memory", "q_nnf", "q_pos_ext",
        "q_pos_int")))
    for name in BLOCK_ORDER:
        blk = builder.blocks[name]
        offset = blk.trace_offset
        size = len(blk)
        if size > 0:
            active.add_range(offset, offset + size)
        for row in range(size):
            for widx, wname in enumerate(wire_names):
                var_idx = blk.wires[widx][row]
                real = builder.real_variable_index[var_idx]
                trace_row = row + offset
                polys[wname][trace_row] = builder.variables[real]
                copy_cycles[real].append((widx, trace_row))
        for sname, col in blk.sel.items():
            dst = polys[sel_to_precomputed[sname]]
            for row, v in enumerate(col):
                dst[offset + row] = v

    _compute_permutation_polys(builder, polys, copy_cycles, n, active)

    polys["lagrange_first"][0] = 1
    polys["lagrange_last"][final_active_wire_idx] = 1

    tables = builder_gadgets.construct_lookup_table_polynomials(builder, n)
    for i in range(4):
        polys[f"table_{i + 1}"] = tables[i]
    counts, tags = builder_gadgets.construct_lookup_read_counts(builder, n)
    polys["lookup_read_counts"] = counts
    polys["lookup_read_tags"] = tags

    pub_block = builder.blocks["pub_inputs"]
    num_pub = len(pub_block)
    pub_offset = pub_block.trace_offset
    public_inputs = [polys["w_r"][pub_offset + i] for i in range(num_pub)]
    d = getattr(builder, "d", None)
    if d is not None and any(d.is_shared(v) for v in public_inputs):
        # public inputs are public by definition: open them (the witness
        # wires stay shared; co-builder opens exactly these)
        public_inputs = [int(d.open(v)) if d.is_shared(v) else int(v)
                         for v in public_inputs]
        for i, v in enumerate(public_inputs):
            polys["w_r"][pub_offset + i] = v
            polys["w_l"][pub_offset + i] = v

    return ProvingKey(
        circuit_size=n, log_circuit_size=(n - 1).bit_length(),
        public_inputs=public_inputs, num_public_inputs=num_pub,
        pub_inputs_offset=pub_offset, polynomials=polys,
        memory_read_records=read_records, memory_write_records=write_records,
        final_active_wire_idx=final_active_wire_idx,
        active_region_data=active)


def _compute_permutation_polys(builder, polys, copy_cycles, n, active):
    """plain_proving_key.rs:186-340."""
    # mapping[col][row] = (row_index, column_index, is_public_input, is_tag)
    sigmas = [[[row, col, False, False] for row in range(n)]
              for col in range(NUM_WIRES)]
    ids = [[[row, col, False, False] for row in range(n)]
           for col in range(NUM_WIRES)]

    for cycle_idx, cycle in enumerate(copy_cycles):
        if not cycle:
            continue
        first_col, first_row = cycle[0]
        last_col, last_row = cycle[-1]
        cycle_tag = builder.real_variable_tags[cycle_idx]
        ids[first_col][first_row][3] = True
        ids[first_col][first_row][0] = cycle_tag
        sigmas[last_col][last_row][3] = True
        sigmas[last_col][last_row][0] = builder.tau[cycle_tag]
        for k in range(len(cycle) - 1):
            ccol, crow = cycle[k]
            ncol, nrow = cycle[k + 1]
            sigmas[ccol][crow][0] = nrow
            sigmas[ccol][crow][1] = ncol

    pub_offset = builder.blocks["pub_inputs"].trace_offset
    for i in range(len(builder.public_inputs)):
        idx = i + pub_offset
        sigmas[0][idx][0] = idx
        sigmas[0][idx][1] = 0
        sigmas[0][idx][2] = True

    sep = PERMUTATION_SEPARATOR
    for col in range(NUM_WIRES):
        sig = polys[f"sigma_{col + 1}"]
        idp = polys[f"id_{col + 1}"]
        for i in range(active.size()):
            row = active.idxs[i]
            for mapping, dst in ((sigmas, sig), (ids, idp)):
                r, c, is_pub, is_tag = mapping[col][row]
                if is_pub:
                    dst[row] = -(r + 1 + sep * c) % R
                elif is_tag:
                    dst[row] = (sep * NUM_WIRES + r) % R
                else:
                    dst[row] = (r + sep * c) % R


def create_vk(pk: ProvingKey, crs) -> VerifyingKey:
    """The 28 precomputed commitments. A key whose polynomials are tensors
    needs the CRS on their device (a host CRS counts as the CPU)."""
    if pk.device is not None:
        polyops.check_crs_device(crs, pk.device)
    commitments = [polyops.commit(pk.polynomials[name], crs)
                   for name in PRECOMPUTED]
    return VerifyingKey(
        log_circuit_size=pk.log_circuit_size,
        num_public_inputs=pk.num_public_inputs,
        pub_inputs_offset=pk.pub_inputs_offset,
        commitments=commitments)
