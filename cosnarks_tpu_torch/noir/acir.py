"""Port of `cosnarks_tpu.noir.acir`: host Python, copied with two changes:
the msgpack bytecode is read by the port's own `_msgpack`, so loading an
artifact needs no `msgpack` package, and `dump_artifact` writes one.

Noir/ACIR artifact parsing.

The Noir compiler emits a JSON artifact whose `bytecode` is a gzipped
msgpack `Program` (version byte + [[functions], [brillig_functions]]) —
reference consumes it via the external acir crates
(co-noir/co-builder/src/lib.rs:21 constraint_system_from_reader). We parse
the msgpack directly: it is self-describing, so no serde-layout
reimplementation is needed.

Field elements appear as 32-byte big-endian blobs (or hex strings);
witnesses as plain ints inside expressions and {"Witness": n} in
black-box FunctionInputs.
"""

from __future__ import annotations

import base64
import dataclasses
import gzip
import json

from . import _msgpack


def _fe(v) -> int:
    """Field element from msgpack: bytes (BE) or hex str."""
    if isinstance(v, bytes):
        return int.from_bytes(v, "big")
    if isinstance(v, str):
        return int(v, 16)
    return int(v)


def _finput(v):
    """FunctionInput -> ("w", idx) | ("c", value)."""
    if isinstance(v, dict):
        if "Witness" in v:
            return ("w", int(v["Witness"]))
        if "Constant" in v:
            return ("c", _fe(v["Constant"]))
    raise ValueError(f"unhandled FunctionInput {v!r}")


@dataclasses.dataclass
class Expression:
    """q_c + sum c*w_i + sum c*w_i*w_j (ACIR arithmetic expression)."""

    mul: list  # [(coef, w1, w2)]
    lin: list  # [(coef, w)]
    qc: int

    @classmethod
    def parse(cls, raw):
        muls = [(_fe(c), int(w1), int(w2)) for c, w1, w2 in raw[0]]
        lins = [(_fe(c), int(w)) for c, w in raw[1]]
        return cls(muls, lins, _fe(raw[2]))


@dataclasses.dataclass
class AcirFunction:
    name: str
    current_witness: int
    opcodes: list  # (kind, payload)
    private_params: list
    public_params: list
    return_values: list


@dataclasses.dataclass
class Artifact:
    abi: dict
    functions: list
    brillig: list  # raw (unconstrained) function blobs
    noir_version: str


def _parse_opcode(op):
    (kind, payload), = op.items() if isinstance(op, dict) else ((op, None),)
    if kind == "AssertZero":
        return ("assert_zero", Expression.parse(payload))
    if kind == "BlackBoxFuncCall":
        (bb, args), = payload.items()
        return ("blackbox", (bb, args))
    if kind == "MemoryInit":
        block_id, witnesses, block_type = payload
        return ("memory_init", (int(block_id), [int(w) for w in witnesses],
                                block_type))
    if kind == "MemoryOp":
        block_id, (operation, index, value) = payload[0], payload[1]
        return ("memory_op", (int(block_id), Expression.parse(operation),
                              Expression.parse(index),
                              Expression.parse(value)))
    if kind == "BrilligCall":
        return ("brillig_call", payload)
    if kind == "Call":
        return ("call", payload)
    return ("unknown", (kind, payload))


def load_artifact(path) -> Artifact:
    art = json.load(open(path))
    raw = gzip.decompress(base64.b64decode(art["bytecode"]))
    prog = _msgpack.unpackb(raw[1:])
    fns = []
    for f in prog[0]:
        name, cw, ops, priv, pub, ret = f[0], f[1], f[2], f[3], f[4], f[5]
        fns.append(AcirFunction(
            name=name, current_witness=int(cw),
            opcodes=[_parse_opcode(o) for o in ops],
            private_params=[int(w) for w in priv],
            public_params=[int(w) for w in pub],
            return_values=[int(w) for w in ret],
        ))
    return Artifact(abi=art["abi"], functions=fns,
                    brillig=prog[1] if len(prog) > 1 else [],
                    noir_version=art.get("noir_version", ""))


def dump_artifact(path, abi: dict, functions: list, brillig: list,
                  noir_version: str = "", version_byte: int = 1) -> None:
    """Write a Noir JSON artifact: `bytecode` is base64 of gzip of the
    version byte + msgpack [functions, brillig], each function the raw
    [name, current_witness, opcodes, private, public, return] list that
    `load_artifact` reads."""
    raw = bytes([version_byte]) + _msgpack.packb([functions, brillig])
    art = {"noir_version": noir_version, "abi": abi,
           "bytecode": base64.b64encode(gzip.compress(raw, mtime=0))
           .decode("ascii")}
    with open(path, "w") as fh:
        json.dump(art, fh)


def load_witness_stack(path) -> dict[int, int]:
    """Expected-witness KAT (.gz): gzipped msgpack witness stack ->
    {witness_index: value}."""
    raw = gzip.decompress(open(path, "rb").read())
    obj = _msgpack.unpackb(raw[1:])
    stack = obj[0]
    _, wmap = stack[-1][0], stack[-1]
    # entry = [index, {witness: fe}]
    entries = wmap[1]
    return {int(k): _fe(v) for k, v in entries.items()}


def write_witness_stack(path, wmap: dict[int, int]) -> None:
    """`load_witness_stack`'s inverse: one witness map as a gzipped
    msgpack witness stack (a format byte, then [[[0, {index: value}]]]
    with each value a 32-byte big-endian field element)."""
    entries = {int(k): int(v).to_bytes(32, "big")
               for k, v in sorted(wmap.items())}
    raw = b"\x02" + _msgpack.packb([[[0, entries]]])
    with open(path, "wb") as fh:
        fh.write(gzip.compress(raw, mtime=0))


# -- ABI encoding ------------------------------------------------------------

def _flatten_value(typ, val, p):
    """Prover.toml value -> list of field elements per abi type."""
    kind = typ["kind"]
    if kind == "field":
        return [_toml_int(val, p)]
    if kind == "integer":
        return [_toml_int(val, p)]
    if kind == "boolean":
        v = val if isinstance(val, bool) else _toml_int(val, p)
        return [int(bool(v))]
    if kind == "array":
        out = []
        items = list(val)
        n = typ.get("length", len(items))
        items = items[:n] + [0] * max(0, n - len(items))
        for item in items:
            out.extend(_flatten_value(typ["type"], item, p))
        return out
    if kind == "string":
        s = val.encode()
        return [b for b in s]
    if kind == "struct":
        out = []
        for f in typ["fields"]:
            out.extend(_flatten_value(f["type"], val[f["name"]], p))
        return out
    if kind == "tuple":
        out = []
        for t, v in zip(typ["fields"], val):
            out.extend(_flatten_value(t, v, p))
        return out
    raise ValueError(f"unhandled abi type {kind}")


def _toml_int(val, p):
    if isinstance(val, int):
        return val % p
    s = str(val).strip()
    if s.startswith("-"):
        return (-int(s[1:], 0)) % p
    return int(s, 0) % p


def encode_inputs(abi: dict, prover_toml: dict, p: int) -> list[int]:
    """Flatten Prover.toml inputs to the initial witness values in
    parameter declaration order (witness 0..k-1)."""
    out = []
    for param in abi["parameters"]:
        out.extend(_flatten_value(param["type"], prover_toml[param["name"]],
                                  p))
    return out


def encode_inputs_by_name(abi: dict, prover_toml: dict,
                          p: int) -> dict[str, list[int]]:
    """Flatten a (possibly partial) Prover.toml to {param name: field
    values}; only parameters present in the TOML are encoded. Mirrors the
    reference's name-keyed Rep3SharedInput maps
    (co-noir/co-noir-types/src/lib.rs merge_input_shares), which lets
    several input providers each share a disjoint subset of the ABI."""
    out = {}
    for param in abi["parameters"]:
        if param["name"] in prover_toml:
            out[param["name"]] = _flatten_value(
                param["type"], prover_toml[param["name"]], p)
    return out


def flatten_named_inputs(abi: dict, named: dict[str, list]) -> list:
    """Order name-keyed flattened inputs into the initial witness list;
    every ABI parameter must be present."""
    out = []
    for param in abi["parameters"]:
        if param["name"] not in named:
            raise ValueError(
                f"input parameter '{param['name']}' missing from shares")
        out.extend(named[param["name"]])
    return out
