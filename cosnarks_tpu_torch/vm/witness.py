"""Port of `cosnarks_tpu.vm.witness`: host Python, copied unchanged.

Witness-vector assembly from an executed circuit instance.

Wire ordering follows circom's r1cs numbering: wire 0 = 1, then main's
outputs, public inputs, private inputs (declaration order, row-major
flattening), then intermediate signals of the component tree in DFS
instantiation order. This matches circuits compiled without signal
simplification (--O0) and, for circuits whose non-IO signals are all
quadratic-defined, the default O1 zkeys as well (e.g. the reference
Groth16 test vectors). A `.sym`-guided mapping for arbitrary O1/O2
artifacts is the planned general path.
"""

from __future__ import annotations

from . import interp, lang
from .interp import Instance, _count, _indices


def witness_vector(vm: interp.WitnessVM, main: Instance,
                   public_inputs: list[str] | None = None) -> list[int]:
    out = [1]
    pubs = set(public_inputs or vm.prog.main_public)

    def signal_vals(inst, name):
        info = inst.signals[name]
        return [info.values.get(idx, 0) for idx in _indices(info.dims)]

    # main outputs
    for name in main.signal_order:
        if main.signals[name].kind == "output":
            out.extend(signal_vals(main, name))
    # public inputs then private inputs
    for want_pub in (True, False):
        for name in main.signal_order:
            if main.signals[name].kind == "input" and (name in pubs) == want_pub:
                out.extend(signal_vals(main, name))
    # intermediates: DFS over the component tree
    def visit(inst, is_main):
        for name in inst.signal_order:
            kind = inst.signals[name].kind
            if is_main and kind in ("input", "output"):
                continue
            if not is_main and kind == "output":
                # subcomponent outputs are their own wires
                out.extend(signal_vals(inst, name))
            elif not is_main and kind == "input":
                out.extend(signal_vals(inst, name))
            elif kind == "intermediate":
                out.extend(signal_vals(inst, name))
        for cname in inst.components:
            comp = inst.components[cname]
            children = (
                comp.values() if isinstance(comp, dict) else [comp]
            )
            for ch in children:
                visit(ch, False)

    visit(main, True)
    return out


def witness_labels(vm: interp.WitnessVM, main: Instance,
                   public_inputs: list[str] | None = None) -> list[str]:
    """Debug companion of witness_vector: 'component.path.signal[idx]' per
    wire, same ordering."""
    out = ["1"]
    pubs = set(public_inputs or vm.prog.main_public)

    def names(inst, name, prefix):
        info = inst.signals[name]
        return [
            f"{prefix}{name}" + "".join(f"[{i}]" for i in idx)
            for idx in _indices(info.dims)
        ]

    for name in main.signal_order:
        if main.signals[name].kind == "output":
            out.extend(names(main, name, "main."))
    for want_pub in (True, False):
        for name in main.signal_order:
            if main.signals[name].kind == "input" and (name in pubs) == want_pub:
                out.extend(names(main, name, "main."))

    def visit(inst, is_main, prefix):
        for name in inst.signal_order:
            kind = inst.signals[name].kind
            if is_main and kind in ("input", "output"):
                continue
            if not is_main and kind in ("output", "input"):
                out.extend(names(inst, name, prefix))
            elif kind == "intermediate":
                out.extend(names(inst, name, prefix))
        for cname in inst.components:
            comp = inst.components[cname]
            items = (
                comp.items() if isinstance(comp, dict) else [((), comp)]
            )
            for idx, ch in items:
                sub = f"{prefix}{cname}" + "".join(
                    f"[{i}]" for i in (idx if isinstance(idx, tuple) else (idx,))
                ) + "." if idx != () else f"{prefix}{cname}."
                visit(ch, False, sub)

    visit(main, True, "main.")
    return out


def n_public(vm: interp.WitnessVM, main: Instance) -> int:
    """Instance count = 1 + #outputs + #public inputs (snarkjs nPublic+1)."""
    pubs = set(vm.prog.main_public)
    n = 1
    for name in main.signal_order:
        info = main.signals[name]
        if info.kind == "output" or (info.kind == "input" and name in pubs):
            n += _count(info.dims)
    return n


def generate_witness(circuit_path: str, inputs: dict, field,
                     search_paths=(), sym_path: str | None = None
                     ) -> tuple[list[int], int]:
    """Full plain-driver witness extension: returns (witness vector,
    n_instance). Mirrors co_circom::generate_witness (plain driver).

    sym_path: a circom `.sym` file for the matching -O1/-O2 artifact;
    the O0 witness is reordered/filtered into the simplified wire order
    so the output matches zkeys built with signal simplification."""
    prog = lang.load_program(circuit_path, search_paths=search_paths)
    vm = interp.WitnessVM(prog, field)
    main = vm.run(inputs)
    wit = witness_vector(vm, main)
    if sym_path is not None:
        from ..io import sym

        sym_map, n_wires = sym.load_sym(sym_path)
        labels = witness_labels(vm, main)
        wit = sym.map_witness(sym_map, n_wires, labels, wit)
    return wit, n_public(vm, main)
