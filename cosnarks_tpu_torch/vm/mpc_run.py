"""Port of `cosnarks_tpu.vm.mpc_run`: host Python copied unchanged, apart
from `to_shared_witness_file`, which encodes the shares on a torch device.

MPC witness-extension plumbing: input splitting, party execution,
witness recombination.

Host-side counterpart of co_circom::{split_input, generate_witness_rep3}
(co-circom/src/lib.rs:46-147): inputs are secret-shared per leaf, each party
runs the interpreter with the Rep3 driver, and the resulting witness vector
is a mix of public ints (values never touched by a share) and AShare leaves.
"""

from __future__ import annotations

from ..ff.spec import Field
from ..mpc.rep3_scalar import AShare, Rep3Scalar
from . import interp, lang, witness
from .rep3_driver import setup_rep3_vm


def split_input_tree(inputs: dict, field: Field) -> list[dict]:
    """Share every leaf of an input dict into 3 per-party trees
    (co-circom-types Rep3SharedInput, lib.rs:21-150 — here all leaves
    shared; public inputs are re-merged by the caller if desired)."""
    p = field.p

    def rec(v):
        if isinstance(v, (list, tuple)):
            parts = [rec(x) for x in v]
            return [[q[i] for q in parts] for i in range(3)]
        s = Rep3Scalar.share(int(v) % p, p)
        return [s[0], s[1], s[2]]

    outs: list[dict] = [{}, {}, {}]
    for k, v in inputs.items():
        r = rec(v)
        for i in range(3):
            outs[i][k] = r[i]
    return outs


def promote_trivial(v, party_id: int, p: int) -> AShare:
    vv = int(v) % p
    if party_id == 0:
        return AShare(vv, 0)
    if party_id == 2:
        return AShare(0, vv)
    return AShare(0, 0)


def combine_witnesses(per_party: list[list], field: Field) -> list[int]:
    """Recombine 3 parties' witness vectors (ints and/or AShares) into
    cleartext ints, consistency-checking replication."""
    p = field.p
    n = len(per_party[0])
    if any(len(w) != n for w in per_party):
        raise ValueError("witness length mismatch across parties")
    out = []
    for j in range(n):
        vals = [w[j] for w in per_party]
        if all(not isinstance(v, AShare) for v in vals):
            if not (int(vals[0]) == int(vals[1]) == int(vals[2])):
                raise ValueError(f"public wire {j} differs across parties")
            out.append(int(vals[0]) % p)
        else:
            shs = [
                v if isinstance(v, AShare) else promote_trivial(v, i, p)
                for i, v in enumerate(vals)
            ]
            out.append(Rep3Scalar.combine(shs, p))
    return out


def run_rep3_witness_extension(
    prog: lang.Program,
    field: Field,
    shared_inputs: dict,
    net,
    seed: bytes | None = None,
    party_rng=None,
    allow_logs: bool = False,
):
    """One party's generate-witness: returns (witness list of int|AShare,
    n_instance, driver). Mirrors generate_witness_rep3
    (co-circom/src/lib.rs:118)."""
    driver = setup_rep3_vm(net, field, party_rng=party_rng, seed=seed)
    vm = interp.WitnessVM(prog, field, driver=driver, allow_logs=allow_logs)
    main = vm.run(shared_inputs)
    return witness.witness_vector(vm, main), witness.n_public(vm, main), driver


def shared_input_to_tree(parsed: dict, field: Field, party_id: int) -> dict:
    """Per-party shared-input JSON dict (io/shared.py split_input_rep3
    format) -> VM input tree of int | AShare leaves."""
    p = field.p
    out = {}
    for name, entry in parsed.items():
        if isinstance(entry, dict) and "kind" in entry:
            if entry["kind"] == "public":
                vals = [int(v) % p for v in entry["values"]]
                is_list = entry.get("shape", "scalar") == "list"
                out[name] = vals if is_list else vals[0]
            else:
                pairs = [
                    AShare(int(a) % p, int(b) % p)
                    for a, b in zip(entry["a"], entry["b"])
                ]
                out[name] = pairs if entry["shape"] == "list" else pairs[0]
        else:  # plain JSON leaf (cleartext input)
            out[name] = entry
    return out


def to_shared_witness_file(proto: Rep3Scalar, field: Field,
                           wit: list, n_inst: int, party_id: int,
                           device=None):
    """Witness vector of int|AShare -> SharedWitnessFile: the instance part
    (wire 0, outputs, public inputs) is opened to cleartext, the rest is
    promoted/kept as replicated shares (the reference's SharedWitness split,
    co-circom-types/src/lib.rs:21-80). The share limbs go to `device`
    (default: the package's, else cuda) and are Montgomery-encoded there."""
    import torch

    from .. import resolve_device
    from ..ff import mont
    from ..ff.bigint import ints_to_limbs
    from ..io import shared as shared_io

    device = resolve_device(device)
    inst = wit[:n_inst]
    idxs = [j for j, v in enumerate(inst) if isinstance(v, AShare)]
    if idxs:
        opened = proto.open_many([inst[j] for j in idxs])
        for j, v in zip(idxs, opened):
            inst[j] = v
    pubs = [int(v) % field.p for v in inst]

    rest = [
        v if isinstance(v, AShare) else promote_trivial(v, party_id, field.p)
        for v in wit[n_inst:]
    ]

    def encode(vals):
        limbs = ints_to_limbs(vals, field.nlimbs).astype("int64")
        return mont.to_mont(field, torch.as_tensor(limbs, device=device))

    return shared_io.SharedWitnessFile(
        shared_io.PROTO_REP3, party_id, 3, 1, field, pubs,
        encode([s.a for s in rest]), encode([s.b for s in rest])
    )
