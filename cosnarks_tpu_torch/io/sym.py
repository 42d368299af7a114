"""circom `.sym` symbol files: signal name -> r1cs wire index (copy of
cosnarks_tpu.io.sym).

circom -O1/-O2 eliminate linearly-dependent signals and renumber the
survivors; the emitted `circuit.sym` records, per original signal,
`#signal_id, #witness_wire (-1 if eliminated), #component, qualified_name`.
The reference inherits the mapping by compiling circuits with a circom
fork (co-circom/circom-mpc-compiler); we instead map our O0 witness onto
the simplified wire order via the names (vm/witness.py witness_labels
produces the same qualified-name format)."""

from __future__ import annotations


def load_sym(path: str) -> tuple[dict[str, int], int]:
    """Parse a .sym file. Returns (name -> wire index for surviving
    signals, total wire count incl. wire 0)."""
    mapping: dict[str, int] = {}
    max_wire = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",", 3)
            if len(parts) != 4:
                raise ValueError(f"malformed .sym line: {line!r}")
            wire = int(parts[1])
            name = parts[3]
            if wire >= 0:
                mapping[name] = wire
                max_wire = max(max_wire, wire)
    return mapping, max_wire + 1


def map_witness(sym_map: dict[str, int], n_wires: int,
                labels: list[str], values: list):
    """Reorder an O0 witness (labels[i] names values[i]) into simplified
    wire order. Works on any value type (ints or shares). Wire 0 is the
    constant from values[0]."""
    by_name = dict(zip(labels, values))
    out = [None] * n_wires
    out[0] = values[0]
    missing = []
    for name, wire in sym_map.items():
        v = by_name.get(name)
        if v is None:
            missing.append(name)
        else:
            out[wire] = v
    if missing:
        raise ValueError(
            f".sym names not found in circuit signals: {missing[:5]}"
            + (f" (+{len(missing)-5} more)" if len(missing) > 5 else "")
        )
    holes = [i for i, v in enumerate(out) if v is None]
    if holes:
        raise ValueError(f"wires with no .sym mapping: {holes[:5]}")
    return out
