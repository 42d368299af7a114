"""co-noir CLI: PyTorch port of cosnarks_tpu.noir.cli (reference
co-noir/src/bin/co-noir.rs:773-803).

Subcommands: split-input, split-witness, merge-input-shares,
generate-witness (PLAIN / REP3 over a network config), circuit-info,
prove, create-vk, verify, split-proving-key (REP3 / SHAMIR),
build-proving-key, generate-proof (REP3 / SHAMIR),
build-and-generate-proof and download-crs, with the JAX CLI's options
and files, so that a file written by one package is read by the other.
Run one party per process:

  python -m cosnarks_tpu_torch.noir generate-proof --protocol SHAMIR \\
      --proving-key pk.0.shared --proving-key-public pk_public.npz \\
      --config party0.toml --out proof.bin --public-input public.bin

Every subcommand runs on the CUDA card unless given `--device cpu` (or
COSNARKS_DEVICE=cpu); with no card and no `--device cpu` it raises
(`resolve_device`), it never carries on on the CPU. On the card the CRS's
points live there and every commitment runs `msm()`; on the CPU the CRS
is a host one, committed to by the host Pippenger. Proving keys, shares
received from peers and the co-prover's tensors land on that device.
COSNARKS_QUIET=1 silences the per-phase wall-time, byte-counter and
kernel-launch report on stderr.

Share artifacts are versioned JSON (`cosnarks-noir-shared-*`): witness
entries map ACIR witness index -> [a, b] replicated share ints,
proving-key entries map a witness polynomial to [[a, b], ...] (REP3) or
[[s], ...] (SHAMIR); the public half of a proving key is `pk_public.npz`.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import secrets
import sys
import tomllib
import types

from .. import resolve_device
from ..ff.spec import BN254_FR
from ..utils import timing
from ..utils.timing import phase, report_net
from . import acir, solver

_FMT_INPUT = "cosnarks-noir-shared-input"
_FMT_WITNESS = "cosnarks-noir-shared-witness"
_FMT_PK = "cosnarks-noir-shared-pk"


def _share3(v: int, p: int) -> list[tuple[int, int]]:
    """Replicated shares [(a_i, a_{i+1})] of v (party i holds
    (x_i, x_{i+1}))."""
    x0, x1 = secrets.randbelow(p), secrets.randbelow(p)
    x2 = (v - x0 - x1) % p
    xs = [x0, x1, x2]
    return [(xs[i], xs[(i + 1) % 3]) for i in range(3)]


def _write_share_file(path: str, fmt: str, party: int, entries):
    with open(path, "w") as fh:
        json.dump(
            {"format": fmt, "version": 1, "protocol": "REP3",
             "party": party, "entries": entries}, fh)


def _read_share_file(path: str, fmt: str):
    with open(path) as fh:
        data = json.load(fh)
    if data.get("format") != fmt or data.get("version") != 1:
        raise ValueError(f"{path}: not a {fmt} v1 file")
    return data


def _connect(args):
    from ..mpc.net.config import NetworkConfig

    with phase("Establish network"):
        return NetworkConfig.from_toml(args.config).connect(
            device=args.device)


def _report(net):
    report_net(net)
    timing.report_launches()


def cmd_split_input(args):
    """Share a (possibly partial) Prover.toml. Entries are keyed by ABI
    input NAME (reference co-noir-types merge_input_shares merges by
    name), so several providers can each share a disjoint parameter
    subset and merge-input-shares stitches them together."""
    p = BN254_FR.p
    art = acir.load_artifact(args.circuit)
    with open(args.input, "rb") as fh:
        prover = tomllib.load(fh)
    named = acir.encode_inputs_by_name(art.abi, prover, p)
    if not named:
        raise ValueError("Prover.toml provides no ABI inputs")
    per_party = [dict() for _ in range(3)]
    for name, values in named.items():
        shares = [[] for _ in range(3)]
        for v in values:
            for k, sh in enumerate(_share3(v, p)):
                shares[k].append(list(sh))
        for k in range(3):
            per_party[k][name] = shares[k]
    base = os.path.basename(args.input)
    os.makedirs(args.out_dir, exist_ok=True)
    for k in range(3):
        out = os.path.join(args.out_dir, f"{base}.{k}.shared")
        _write_share_file(out, _FMT_INPUT, k, per_party[k])
        print(f"wrote {out}")


def cmd_split_witness(args):
    p = BN254_FR.p
    wit = acir.load_witness_stack(args.witness)
    per_party = [dict() for _ in range(3)]
    for idx, v in wit.items():
        for k, sh in enumerate(_share3(v, p)):
            per_party[k][str(idx)] = sh
    base = os.path.basename(args.witness)
    os.makedirs(args.out_dir, exist_ok=True)
    for k in range(3):
        out = os.path.join(args.out_dir, f"{base}.{k}.shared")
        _write_share_file(out, _FMT_WITNESS, k, per_party[k])
        print(f"wrote {out}")


def cmd_merge_input_shares(args):
    """Merge per-provider input shares by ABI input name (each provider
    shares a disjoint subset of the ABI inputs; reference
    co-noir-types merge_input_shares / co-noir.rs MergeInputShares).
    Duplicate parameter names across providers are an error."""
    merged: dict = {}
    party = None
    for path in args.inputs:
        data = _read_share_file(path, _FMT_INPUT)
        if party is None:
            party = data["party"]
        if data["party"] != party:
            raise ValueError("input shares stem from different party ids")
        for name, sh in data["entries"].items():
            if name in merged:
                raise ValueError(
                    f"input '{name}' provided by more than one share file")
            merged[name] = sh
    _write_share_file(args.out, _FMT_INPUT, party, merged)
    print(f"wrote {args.out}")


def _rep3_vm(net):
    """The co-ACVM's Rep3 driver with fresh correlated PRF keys: party i
    draws key_mine and sends it to the PREVIOUS party, whose key_next it
    becomes (one round; rep3.rs:71-110)."""
    from ..mpc.rep3_scalar import HostRng, Rep3Scalar
    from ..vm.rep3_driver import Rep3Driver

    seed_mine = secrets.token_bytes(32)
    key_next = net.reshare_backward(seed_mine)
    rng = HostRng(seed_mine, key_next)
    return Rep3Driver(Rep3Scalar(net, rng, BN254_FR.p), BN254_FR)


def cmd_generate_witness(args):
    art = acir.load_artifact(args.circuit)
    p = BN254_FR.p
    if args.protocol == "PLAIN":
        from ..vm.interp import PlainDriver

        with open(args.input, "rb") as fh:
            prover = tomllib.load(fh)
        values = acir.encode_inputs(art.abi, prover, p)
        with phase("Witness extension"):
            wit = solver.solve_program(art, PlainDriver(BN254_FR), p, values)
        with open(args.out, "w") as fh:
            json.dump({k: str(int(v)) for k, v in sorted(wit.items())}, fh)
        print(f"wrote {args.out}")
        return
    from ..mpc.rep3_scalar import AShare

    data = _read_share_file(args.input, _FMT_INPUT)
    inputs = [AShare(*sh) for sh in
              acir.flatten_named_inputs(art.abi, data["entries"])]
    net = _connect(args)
    try:
        with phase("Witness extension"):
            drv = _rep3_vm(net)
            wit = solver.solve_program(art, drv, p, inputs)
        entries = {}
        for k, v in wit.items():
            sh = drv.to_share(v)
            entries[str(k)] = [int(sh.a), int(sh.b)]
        _write_share_file(args.out, _FMT_WITNESS, net.id, entries)
        print(f"wrote {args.out}")
        _report(net)
    finally:
        net.close()


def _local_crs(size: int, device):
    """The local known-tau CRS of `size` points: on the card with its
    points there (made there by `scalar_mul`), else on the host."""
    from ..honk import crs as hcrs

    if device.type == "cpu":
        return hcrs.local_crs(size)
    return hcrs.local_crs(size, device=device)


def _load_crs(args, size: int):
    """CRS from Barretenberg .dat files when provided (DownloadCrs output /
    ~/.bb-crs), else the local known-tau CRS (zero-egress default), on the
    command's device: its points on the card, a host CRS on the CPU."""
    from ..honk import crs as hcrs

    if getattr(args, "crs_g1", None):
        monomials = hcrs.read_g1_dat(args.crs_g1, size)
        g2 = hcrs.read_g2_dat(args.crs_g2) if getattr(args, "crs_g2", None) \
            else hcrs.read_g2_dat()
        crs = hcrs.Crs(monomials, g2)
        return crs if args.device.type == "cpu" else crs.to(args.device)
    return _local_crs(size, args.device)


def _build_pk(circuit_path: str, witness: list[int] | None):
    from ..honk import builder as hbuilder
    from ..honk import proving_key as hpk

    art = acir.load_artifact(circuit_path)
    af = hbuilder.AcirFormat.from_function(art.functions[0])
    if witness is None:
        witness = [0] * (af.max_witness_index + 1)  # write-vk mode
    else:
        witness = list(witness) + [0] * (af.max_witness_index + 1
                                         - len(witness))
    b = hbuilder.UltraBuilder.create_circuit(af, witness)
    return hpk.create_proving_key(b)


def _witness_pk(args):
    wit = acir.load_witness_stack(args.witness)
    return _build_pk(args.circuit, [wit.get(i, 0) for i in
                                    range(max(wit) + 1)])


def _hasher(args):
    from ..honk import transcript as ht

    return ht.HASHERS["keccak" if args.hasher.upper() == "KECCAK"
                      else "poseidon2"]


def _on_device(pk, args, names=None):
    """The key with its polynomials `names` (default: all) on the card; a
    host key on the CPU, whose CRS is a host one."""
    return pk if args.device.type == "cpu" else pk.to_device(args.device,
                                                             names)


def cmd_prove(args):
    """Plain (single-party) UltraHonk proof — the reference's plaindriver
    bin (co-noir/src/bin/plaindriver.rs)."""
    from ..honk import prover as hprover
    from ..honk import proving_key as hpk

    pk = _witness_pk(args)
    crs = _load_crs(args, pk.circuit_size)
    pk = _on_device(pk, args)
    vk = hpk.create_vk(pk, crs)
    H = _hasher(args)
    with phase("Generate proof"):
        proof, pub = hprover.prove(pk, vk, crs, H, device=args.device)
    with open(args.out, "wb") as fh:
        fh.write(H.to_buffer(proof))
    with open(args.public_input, "wb") as fh:
        fh.write(H.to_buffer(pub))
    with open(args.vk, "wb") as fh:
        fh.write(vk.to_buffer(keccak=H.name == "keccak"))
    print(f"wrote {args.out}, {args.public_input}, {args.vk}")
    timing.report_launches()


def cmd_create_vk(args):
    from ..honk import proving_key as hpk

    pk = _build_pk(args.circuit, None)
    crs = _load_crs(args, pk.circuit_size)
    vk = hpk.create_vk(_on_device(pk, args), crs)
    H = _hasher(args)
    with open(args.vk, "wb") as fh:
        fh.write(vk.to_buffer(keccak=H.name == "keccak"))
    print(f"wrote {args.vk}")


def cmd_verify(args):
    from ..honk import crs as hcrs
    from ..honk import proving_key as hpk
    from ..honk import verifier as hverifier

    H = _hasher(args)
    with open(args.vk, "rb") as fh:
        vk = hpk.VerifyingKey.from_buffer(fh.read(),
                                          keccak=H.name == "keccak")
    with open(args.proof, "rb") as fh:
        proof = H.from_buffer(fh.read())
    with open(args.public_input, "rb") as fh:
        pub = H.from_buffer(fh.read())
    # the pairing needs only tau * G2, the same for every size
    g2 = (hcrs.read_g2_dat(args.crs_g2) if getattr(args, "crs_g2", None)
          else hcrs.local_crs(1).g2_x)
    ok = hverifier.verify(proof, pub, vk, g2, H)
    print("verified" if ok else "verification FAILED")
    return 0 if ok else 1


def cmd_split_proving_key(args):
    """Build the proving key from circuit + witness and split the witness
    polynomials into 3 Rep3 or n Shamir shares (co-noir.rs
    SplitProvingKey / split_proving_key_shamir)."""
    from ..honk import co_prover as hco

    pk = _witness_pk(args)
    if args.protocol == "SHAMIR":
        from ..honk.shamir_honk import share_proving_key_shamir

        shares = share_proving_key_shamir(pk, random.SystemRandom())

        def per_entry(col):
            return [[int(s)] for s in col]
    else:
        shares = hco.share_proving_key(pk, None)

        def per_entry(col):
            return [[s.a, s.b] for s in col]
    os.makedirs(args.out_dir, exist_ok=True)
    pub_path = os.path.join(args.out_dir, "pk_public.npz")
    _write_public_pk(pk, pub_path)
    for k in range(len(shares)):
        out = os.path.join(args.out_dir, f"pk.{k}.shared")
        entries = {name: per_entry(shares[k][name])
                   for name in hco.SHARED_PK_ENTITIES}
        _write_share_file(out, _FMT_PK, k, entries)
        print(f"wrote {out}")
    print(f"wrote {pub_path}")


def _load_public_pk(path):
    import numpy as np

    from ..honk.co_prover import SHARED_PK_ENTITIES
    from ..honk.proving_key import PRECOMPUTED, ActiveRegionData, ProvingKey

    data = np.load(path)
    n = int(data["circuit_size"])
    polys = {name: [int(v) for v in data[name]] for name in PRECOMPUTED}
    for name in SHARED_PK_ENTITIES:
        polys[name] = [0] * n
    active = ActiveRegionData.new()
    for start, end in data["active_ranges"]:
        active.add_range(int(start), int(end))
    return ProvingKey(
        circuit_size=n, log_circuit_size=(n - 1).bit_length(),
        public_inputs=[int(v) for v in data["public_inputs"]],
        num_public_inputs=int(data["num_public_inputs"]),
        pub_inputs_offset=int(data["pub_inputs_offset"]),
        polynomials=polys,
        memory_read_records=[int(v) for v in data["memory_read_records"]],
        memory_write_records=[int(v) for v in data["memory_write_records"]],
        final_active_wire_idx=int(data["final_active_wire_idx"]),
        active_region_data=active)


def _write_public_pk(pk, pub_path):
    import numpy as np

    from ..honk.proving_key import PRECOMPUTED

    np.savez(pub_path,
             circuit_size=pk.circuit_size,
             num_public_inputs=pk.num_public_inputs,
             pub_inputs_offset=pk.pub_inputs_offset,
             final_active_wire_idx=pk.final_active_wire_idx,
             memory_read_records=np.array(pk.memory_read_records,
                                          dtype=np.int64),
             memory_write_records=np.array(pk.memory_write_records,
                                           dtype=np.int64),
             public_inputs=np.array([str(v) for v in pk.public_inputs]),
             active_ranges=np.array(pk.active_region_data.ranges,
                                    dtype=np.int64).reshape(-1, 2),
             **{name: np.array([str(v) for v in pk.polynomials[name]])
                for name in PRECOMPUTED})


def cmd_build_proving_key(args):
    """Dealer-free: build the proving key from a SHARED witness via the
    MPC UltraCircuitBuilder (reference co-noir.rs BuildProvingKey): each
    party holds its witness share; the wire polynomials come out shared,
    nothing is opened except the public inputs."""
    from ..honk import builder as hbuilder
    from ..honk import co_prover as hco
    from ..honk import proving_key as hpk
    from ..mpc.rep3_scalar import AShare

    art = acir.load_artifact(args.circuit)
    af = hbuilder.AcirFormat.from_function(art.functions[0])
    data = _read_share_file(args.witness, _FMT_WITNESS)
    wmap = {int(k): AShare(int(a), int(b))
            for k, (a, b) in data["entries"].items()}
    witness = [wmap.get(i, 0) for i in range(af.max_witness_index + 1)]
    net = _connect(args)
    try:
        vm_drv = _rep3_vm(net)
        with phase("MPC circuit build"):
            b = hbuilder.UltraBuilder.create_circuit(af, witness,
                                                     driver=vm_drv)
            pk = hpk.create_proving_key(b)
        pk_pub, shared = hco.split_builder_pk(
            pk, types.SimpleNamespace(id=net.id))
        os.makedirs(args.out_dir, exist_ok=True)
        pub_path = os.path.join(args.out_dir, "pk_public.npz")
        _write_public_pk(pk_pub, pub_path)
        out = os.path.join(args.out_dir, f"pk.{net.id}.shared")
        entries = {name: [[s.a, s.b] for s in shared[name]]
                   for name in hco.SHARED_PK_ENTITIES}
        _write_share_file(out, _FMT_PK, net.id, entries)
        print(f"wrote {out}")
        print(f"wrote {pub_path}")
        _report(net)
    finally:
        net.close()


def cmd_generate_proof(args):
    """Collaborative UltraHonk proof from a split proving key: 3-party
    Rep3 or n-party threshold Shamir (co-noir.rs GenerateProof)."""
    from ..honk import co_prover as hco
    from ..honk import proving_key as hpk
    from ..honk.polyops import FR
    from ..mpc.rep3_scalar import AShare

    pk = _load_public_pk(args.proving_key_public)
    data = _read_share_file(args.proving_key, _FMT_PK)
    shamir = getattr(args, "protocol", "REP3") == "SHAMIR"
    if shamir:
        shared = {name: [int(e[0]) for e in entries]
                  for name, entries in data["entries"].items()}
    else:
        shared = {name: [AShare(int(a), int(b)) for a, b in entries]
                  for name, entries in data["entries"].items()}
    crs = _load_crs(args, pk.circuit_size)
    # VK commitments depend only on the public precomputed polynomials
    pk = _on_device(pk, args, hpk.PRECOMPUTED)
    vk = hpk.create_vk(pk, crs)
    H = _hasher(args)
    net = _connect(args)
    try:
        with phase("Generate proof"):
            if shamir:
                from ..honk.shamir_honk import ShamirHonkDriver
                from ..mpc.shamir import ShamirState

                state = ShamirState.setup(net, FR, (net.n_parties - 1) // 2,
                                          device=args.device)
                drv = ShamirHonkDriver(net, state)
            else:
                from ..honk.co_driver import Rep3HonkDriver
                from ..mpc.rep3 import Rep3State

                drv = Rep3HonkDriver(net, Rep3State.setup(
                    net, device=args.device))
            proof, pub = hco.co_prove(pk, shared, vk, crs, H, drv)
        with open(args.out, "wb") as fh:
            fh.write(H.to_buffer(proof))
        with open(args.public_input, "wb") as fh:
            fh.write(H.to_buffer(pub))
        print(f"wrote {args.out}, {args.public_input}")
        _report(net)
        counts = {"rounds": drv.rounds}
        if shamir:
            counts["pair_refills"] = drv.refills
        if args.device.type == "cuda":
            import torch

            counts["peak_device_bytes"] = torch.cuda.max_memory_allocated(
                args.device)
        timing.report_counts(counts)
    finally:
        net.close()


def cmd_build_and_generate_proof(args):
    """BuildProvingKey + GenerateProof in one run without touching disk
    between the phases (co-noir.rs Commands::BuildAndGenerateProof); Rep3
    only."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        bargs = types.SimpleNamespace(
            circuit=args.circuit, witness=args.witness,
            config=args.config, out_dir=d, device=args.device)
        cmd_build_proving_key(bargs)
        # the pk share file carries the party id in its name; find it
        pk_share = [f for f in os.listdir(d) if f.startswith("pk.")][0]
        gargs = types.SimpleNamespace(
            proving_key=os.path.join(d, pk_share),
            proving_key_public=os.path.join(d, "pk_public.npz"),
            config=args.config, out=args.out,
            public_input=args.public_input,
            crs_g1=args.crs_g1, crs_g2=args.crs_g2, hasher=args.hasher,
            device=args.device)
        return cmd_generate_proof(gargs)


def cmd_download_crs(args):
    """Reference download_g1_crs fetches `num_points` of the Aztec
    ignition bn254_g1.dat over HTTPS (co-noir/src/lib.rs:468). This build
    makes no network request, so: --source slices an existing .dat, else
    the LOCAL KNOWN-TAU CRS is generated (self-consistent pairing checks,
    NOT secure: the trapdoor is a public constant)."""
    from ..honk import crs as hcrs

    n = max(1, int(args.num_points))
    if args.source:
        pts = hcrs.read_g1_dat(args.source, n)
    else:
        size = 1
        while size < n:
            size *= 2
        pts = _local_crs(size, args.device).monomials[:n]
        print("warning: wrote LOCAL KNOWN-TAU CRS (testing only; "
              "pass --source for a real ignition .dat)")
    hcrs.write_g1_dat(args.crs, pts)
    print(f"wrote {args.crs} ({n} points)")
    return 0


def cmd_circuit_info(args):
    art = acir.load_artifact(args.circuit)
    fn = art.functions[0]
    kinds = {}
    for op in fn.opcodes:
        kind = op[0] if isinstance(op, tuple) else type(op).__name__
        kinds[kind] = kinds.get(kind, 0) + 1
    print(json.dumps({
        "noir_version": art.noir_version,
        "opcodes": len(fn.opcodes),
        "opcode_kinds": kinds,
        "current_witness_index": fn.current_witness,
        "private_parameters": sorted(fn.private_params),
        "public_parameters": sorted(fn.public_params),
        "return_values": sorted(fn.return_values),
    }, indent=2))


def main(argv=None):
    timing.enable(os.environ.get("COSNARKS_QUIET", "0") != "1")
    ap = argparse.ArgumentParser(
        prog="co-noir",
        description="coNoir pipeline: witness extension, proving keys and "
                    "collaborative UltraHonk proofs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("split-input")
    p.add_argument("--circuit", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--protocol", default="REP3", choices=["REP3"])
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_split_input)

    p = sub.add_parser("split-witness")
    p.add_argument("--witness", required=True,
                   help="nargo witness stack (.gz)")
    p.add_argument("--protocol", default="REP3", choices=["REP3"])
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_split_witness)

    p = sub.add_parser("merge-input-shares")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_merge_input_shares)

    p = sub.add_parser("generate-witness")
    p.add_argument("--circuit", required=True)
    p.add_argument("--input", required=True,
                   help="Prover.toml (PLAIN) or input share file (REP3)")
    p.add_argument("--protocol", default="REP3", choices=["PLAIN", "REP3"])
    p.add_argument("--config", help="network TOML (REP3)")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_generate_witness)

    p = sub.add_parser("circuit-info")
    p.add_argument("--circuit", required=True)
    p.set_defaults(fn=cmd_circuit_info)

    def crs_args(p):
        p.add_argument("--crs-g1", help="Barretenberg bn254_g1.dat "
                       "(default: local known-tau CRS)")
        p.add_argument("--crs-g2", help="Barretenberg bn254_g2.dat")
        p.add_argument("--hasher", default="POSEIDON2",
                       choices=["POSEIDON2", "KECCAK",
                                "poseidon2", "keccak"])

    p = sub.add_parser("prove", help="plain UltraHonk proof (plaindriver)")
    p.add_argument("--circuit", required=True)
    p.add_argument("--witness", required=True, help="nargo witness (.gz)")
    p.add_argument("--out", required=True, help="proof output")
    p.add_argument("--public-input", required=True)
    p.add_argument("--vk", required=True, help="verification key output")
    crs_args(p)
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("create-vk")
    p.add_argument("--circuit", required=True)
    p.add_argument("--vk", required=True)
    crs_args(p)
    p.set_defaults(fn=cmd_create_vk)

    p = sub.add_parser("verify")
    p.add_argument("--proof", required=True)
    p.add_argument("--public-input", required=True)
    p.add_argument("--vk", required=True)
    crs_args(p)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("split-proving-key")
    p.add_argument("--circuit", required=True)
    p.add_argument("--witness", required=True, help="nargo witness (.gz)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--protocol", default="REP3",
                   choices=["REP3", "SHAMIR"])
    p.set_defaults(fn=cmd_split_proving_key)

    p = sub.add_parser("build-proving-key",
                       help="dealer-free MPC proving key from a shared "
                            "witness (co-builder)")
    p.add_argument("--circuit", required=True)
    p.add_argument("--witness", required=True,
                   help="this party's witness.<i>.shared")
    p.add_argument("--config", required=True)
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_build_proving_key)

    p = sub.add_parser(
        "generate-proof",
        help="collaborative UltraHonk proof (3-party Rep3 or n-party "
             "threshold Shamir)")
    p.add_argument("--proving-key", required=True,
                   help="this party's pk.<i>.shared")
    p.add_argument("--proving-key-public", required=True,
                   help="pk_public.npz from split-proving-key")
    p.add_argument("--config", required=True, help="network TOML")
    p.add_argument("--out", required=True)
    p.add_argument("--public-input", required=True)
    p.add_argument("--protocol", default="REP3",
                   choices=["REP3", "SHAMIR"])
    crs_args(p)
    p.set_defaults(fn=cmd_generate_proof)

    p = sub.add_parser(
        "build-and-generate-proof",
        help="build-proving-key + generate-proof in one session "
             "(reference BuildAndGenerateProof)")
    p.add_argument("--circuit", required=True)
    p.add_argument("--witness", required=True,
                   help="this party's witness.<i>.shared")
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--public-input", required=True)
    crs_args(p)
    p.set_defaults(fn=cmd_build_and_generate_proof)

    p = sub.add_parser(
        "download-crs",
        help="materialize a bn254_g1.dat CRS file (reference DownloadCrs "
             "fetches the Aztec ignition CRS; without network access this "
             "slices --source, or writes the LOCAL KNOWN-TAU testing CRS "
             "— not secure for production proofs)")
    p.add_argument("--crs", required=True, help="output .dat path")
    p.add_argument("--num-points", type=int, default=1)
    p.add_argument("--source", help="existing bn254_g1.dat to slice from")
    p.set_defaults(fn=cmd_download_crs)

    for p in sub.choices.values():
        p.add_argument("--device",
                       default=os.environ.get("COSNARKS_DEVICE", "cuda"),
                       help="torch device to run on (cuda, or cpu on a "
                            "machine without a card)")

    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
