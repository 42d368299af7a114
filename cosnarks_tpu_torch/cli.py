"""Port of `cosnarks_tpu.cli`: the co-circom-compatible CLI, the staged
file-based pipeline.

Mirrors the reference binary's subcommands (co-circom/src/bin/
co-circom.rs:560-657): split-witness, split-input, merge-input-shares,
generate-witness, generate-proof, translate-witness, verify. Config
layering: CLI args > env (COSNARKS_*) > TOML.

Run one party per process:
  python -m cosnarks_tpu_torch generate-proof groth16 --zkey c.zkey \
      --witness witness.0.shared --config party0.toml --out proof.json
or all parties in one process for local testing with --local-parties 3.

Every subcommand runs on the CUDA card unless given `--device cpu`; with no
card and no `--device cpu` it raises (`resolve_device`), it never carries
on on the CPU. Shares read from files, encoded by the witness extension
and received from peers land on that device.

Env layering: any long option of any subcommand can be defaulted by
`COSNARKS_<OPTION>` (dashes -> underscores, uppercase; e.g.
COSNARKS_PROTOCOL=REP3, COSNARKS_CONFIG=party0.toml, COSNARKS_DEVICE=cpu).
Explicit CLI args win over env; env wins over the built-in default
(figment-style layering, reference co-circom.rs:495-524). COSNARKS_QUIET=1
silences the per-phase wall-time + byte-counter report.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

from . import resolve_device
from .utils import timing
from .utils.timing import phase


class _EnvDefaultParser(argparse.ArgumentParser):
    """Subcommand parser whose option defaults read COSNARKS_* env vars."""

    def add_argument(self, *names, **kw):
        for n in names:
            if n.startswith("--"):
                env = "COSNARKS_" + n[2:].replace("-", "_").upper()
                if env in os.environ:
                    raw = os.environ[env]
                    typ = kw.get("type")
                    if kw.get("nargs") in ("+", "*"):
                        kw["default"] = raw.split(",")
                        kw.pop("required", None)
                    else:
                        kw["default"] = typ(raw) if typ else raw
                        kw.pop("required", None)
                break
        return super().add_argument(*names, **kw)


def _read(path: str, mode: str = "r"):
    with open(path, mode) as fh:
        return fh.read()


def _write(path: str, data, mode: str = "w"):
    with open(path, mode) as fh:
        fh.write(data)


def _net_from_config(path: str, device):
    from .mpc.net.config import NetworkConfig

    return NetworkConfig.from_toml(path).connect(device=device)


def cmd_split_witness(args):
    import struct

    from .ff.bigint import limbs_to_int
    from .io import shared, wtns, zkey

    data = _read(args.zkey, "rb")
    # section 1 carries the prover type (1 = groth16, 2 = plonk)
    off = 12
    while True:
        sid, size = struct.unpack("<Iq", data[off : off + 12])
        if sid == 1:
            prover_type = struct.unpack("<I", data[off + 12 : off + 16])[0]
            break
        off += 12 + size
    if prover_type == zkey.PLONK:
        zk = zkey.parse_plonk_zkey(data)
    else:
        zk = zkey.parse_groth16_zkey(data)
    _, w = wtns.load_wtns(args.witness)
    wit = [limbs_to_int(x) for x in w]
    n_inst = zk.n_public + 1
    rng = random.SystemRandom()
    if args.protocol == "REP3":
        files = shared.split_witness_rep3(zk.fr, wit, n_inst, rng,
                                          seeded=args.seeded,
                                          device=args.device)
    else:
        files = shared.split_witness_shamir(
            zk.fr, wit, n_inst, args.num_parties, args.threshold, rng,
            device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.basename(args.witness)
    for i, data in enumerate(files):
        out = os.path.join(args.out_dir, f"{base}.{i}.shared")
        _write(out, data, "wb")
        print(f"wrote {out}")


def cmd_split_input(args):
    from .ff.spec import BLS12_381_FR, BN254_FR
    from .io import shared

    field = BN254_FR if args.curve == "BN254" else BLS12_381_FR
    inputs = json.loads(_read(args.input))
    rng = random.SystemRandom()
    outs = shared.split_input_rep3(field, inputs, rng, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.basename(args.input)
    for i, data in enumerate(outs):
        out = os.path.join(args.out_dir, f"{base}.{i}.shared")
        _write(out, data)
        print(f"wrote {out}")


def cmd_merge_input_shares(args):
    from .io import shared

    _write(args.out, shared.merge_input_shares([_read(p) for p in args.inputs]))
    print(f"wrote {args.out}")


def _prove_one_party(zk, swf, net, device):
    from .groth16 import drivers, prove
    from .io import shared as shared_mod
    from .mpc import rep3 as rep3_mod
    from .mpc import shamir as shamir_mod

    if swf.protocol == shared_mod.PROTO_REP3:
        st = rep3_mod.Rep3State.setup(net, device=device)
        driver = drivers.Rep3Driver(net, st)
        witness = prove.SharedWitness(
            swf.public_inputs, rep3_mod.Share(swf.share_a, swf.share_b)
        )
    else:
        st = shamir_mod.ShamirState.setup(net, zk.fr, swf.threshold, pairs=64,
                                          device=device)
        driver = drivers.ShamirDriver(net, st)
        witness = prove.SharedWitness(swf.public_inputs, swf.share_a)
    return prove.prove(driver, zk, witness)


def cmd_generate_witness(args):
    from .ff.bigint import ints_to_limbs
    from .ff.spec import BLS12_381_FR, BN254_FR
    from .io import wtns
    from .vm.witness import generate_witness

    field = BN254_FR if args.curve == "BN254" else BLS12_381_FR
    if args.protocol == "REP3":
        return _generate_witness_rep3(args, field)
    inputs = json.loads(_read(args.input))
    with phase("Witness extension"):
        wit, n_inst = generate_witness(
            args.circuit, inputs, field, search_paths=args.link_library,
            sym_path=args.sym,
        )
    _write(args.out, wtns.write_wtns(field, ints_to_limbs(wit, field.nlimbs)),
           "wb")
    print(f"wrote {args.out} ({len(wit)} wires, {n_inst} instance)")


def _generate_witness_rep3(args, field):
    """MPC witness extension: shared input JSON(s) -> .shared witness file(s)
    (reference generate_witness REP3, co-circom/src/lib.rs:118-147). With
    --local-parties 3, pass all three shared input files; over TCP, pass this
    party's file + --config."""
    from .io import shared as shared_io
    from .vm import lang, mpc_run

    prog = lang.load_program(args.circuit, search_paths=args.link_library)

    def one_party(net, inp_json):
        tree = mpc_run.shared_input_to_tree(
            json.loads(inp_json), field, net.id
        )
        wit, n_inst, driver = mpc_run.run_rep3_witness_extension(
            prog, field, tree, net
        )
        return mpc_run.to_shared_witness_file(
            driver.pr, field, wit, n_inst, net.id, device=args.device
        )

    if args.local_parties:
        from .mpc.net.local import run_parties

        inps = [_read(p) for p in args.input.split(",")]
        if len(inps) != args.local_parties:
            sys.exit("--local-parties needs one --input file per party "
                     "(comma-separated)")
        swfs = run_parties(
            [lambda net, s=s: one_party(net, s) for s in inps]
        )
        for i, swf in enumerate(swfs):
            out = f"{args.out}.{i}.shared"
            _write(out, shared_io.write_shared_witness(swf), "wb")
            print(f"wrote {out}")
    else:
        with phase("Establish network"):
            net = _net_from_config(args.config, args.device)
        try:
            with phase("Witness extension"):
                swf = one_party(net, _read(args.input))
            timing.report_net(net)
            timing.report_launches()
        finally:
            net.close()
        _write(args.out, shared_io.write_shared_witness(swf), "wb")
        print(f"wrote {args.out}")


def _plonk_prove_one_party(zk, swf, net, device):
    from .io import shared as shared_mod
    from .mpc import rep3 as rep3_mod
    from .mpc import shamir as shamir_mod
    from .plonk import drivers, prove

    publics = [int(v) for v in swf.public_inputs]
    if swf.protocol == shared_mod.PROTO_REP3:
        st = rep3_mod.Rep3State.setup(net, device=device)
        drv = drivers.Rep3PlonkDriver(zk.fr, net, st)
        wit = rep3_mod.Share(swf.share_a, swf.share_b)
    else:
        st = shamir_mod.ShamirState.setup(net, zk.fr, swf.threshold,
                                          pairs=64, device=device)
        drv = drivers.ShamirPlonkDriver(zk.fr, net, st)
        wit = swf.share_a
    return prove.prove(zk, drv, publics, wit)


def _prove_all(args, prove_one):
    """Every party's proof for one of generate-proof's provers: all of them
    in this process over LocalNetwork with --local-parties (they must
    agree), else this party's over the --config mesh. Returns (proof, this
    party's or party 0's SharedWitnessFile)."""
    from .io import shared

    swfs = [shared.read_shared_witness(_read(p, "rb"), device=args.device)
            for p in args.witness]
    if args.local_parties:
        from .mpc.net.local import run_parties

        with phase("Generate proof"):
            proofs = run_parties(
                [lambda net, s=s: prove_one(s, net) for s in swfs]
            )
        if any(p != proofs[0] for p in proofs):
            sys.exit("generate-proof: the parties' proofs differ")
        return proofs[0], swfs[0]
    with phase("Establish network"):
        net = _net_from_config(args.config, args.device)
    try:
        with phase("Generate proof"):
            proof = prove_one(swfs[0], net)
        timing.report_net(net)
        timing.report_launches()
    finally:
        net.close()
    return proof, swfs[0]


def cmd_generate_proof(args):
    from .io import jsonio, zkey

    if args.proof_system == "plonk":
        with phase("Parse zkey"):
            zk = zkey.load_plonk_zkey(args.zkey)
        proof, swf = _prove_all(args, lambda s, net: _plonk_prove_one_party(
            zk, s, net, args.device))
        _write(args.out, json.dumps(proof, indent=1))
    else:
        with phase("Parse zkey"):
            zk = zkey.load_groth16_zkey(args.zkey)
        proof, swf = _prove_all(args, lambda s, net: _prove_one_party(
            zk, s, net, args.device))
        curve = "bn128" if zk.fr.name == "bn254_fr" else "bls12381"
        _write(args.out, jsonio.proof_to_json(proof, curve_name=curve))
    if args.public_input:
        _write(args.public_input, jsonio.public_to_json(swf.public_inputs[1:]))
    print(f"wrote {args.out}")


def cmd_translate_witness(args):
    from .io import shared
    from .mpc import bridges
    from .mpc import rep3 as rep3_mod
    from .mpc import shamir as shamir_mod

    swf = shared.read_shared_witness(_read(args.witness, "rb"),
                                     device=args.device)
    if swf.protocol != shared.PROTO_REP3:
        sys.exit("translate-witness: source must be REP3")
    net = _net_from_config(args.config, args.device)
    try:
        st = shamir_mod.ShamirState.setup(
            net, swf.field, 1, pairs=max(64, swf.share_a.shape[0] + 8),
            device=args.device)
        sh = bridges.translate_rep3_to_shamir(
            swf.field, rep3_mod.Share(swf.share_a, swf.share_b), net, st
        )
    finally:
        net.close()
    out = shared.SharedWitnessFile(
        shared.PROTO_SHAMIR, net.id, net.n_parties, 1, swf.field,
        swf.public_inputs, sh, None,
    )
    _write(args.out, shared.write_shared_witness(out), "wb")
    print(f"wrote {args.out}")


def cmd_verify(args):
    from .io import jsonio

    pub = jsonio.public_from_json(_read(args.public_input))
    raw_proof = json.loads(_read(args.proof))
    if (args.proof_system == "plonk"
            or raw_proof.get("protocol") == "plonk"):
        from .plonk.verify import verify as plonk_verify

        ok = plonk_verify(json.loads(_read(args.vk)), raw_proof, pub)
    else:
        from .groth16.verify import verify

        vk = jsonio.vkey_from_json(_read(args.vk))
        proof = jsonio.proof_from_json(_read(args.proof))
        ok = verify(vk, proof, pub)
    print("verification:", "OK" if ok else "FAILED")
    sys.exit(0 if ok else 1)


def main(argv=None):
    timing.enable(os.environ.get("COSNARKS_QUIET", "0") != "1")

    ap = argparse.ArgumentParser(prog="cosnarks_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True,
                            parser_class=_EnvDefaultParser)

    p = sub.add_parser("split-witness")
    p.add_argument("--witness", required=True)
    p.add_argument("--zkey", required=True)
    p.add_argument("--protocol", choices=["REP3", "SHAMIR"], default="REP3")
    p.add_argument("--seeded", action="store_true",
                   help="compressed shares: PRG seeds for 2 of 3 summands "
                        "(CompressedRep3SharedWitness)")
    p.add_argument("--num-parties", type=int, default=3)
    p.add_argument("--threshold", type=int, default=1)
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_split_witness)

    p = sub.add_parser("split-input")
    p.add_argument("--input", required=True)
    p.add_argument("--curve", choices=["BN254", "BLS12-381"], default="BN254")
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_split_input)

    p = sub.add_parser("merge-input-shares")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_merge_input_shares)

    p = sub.add_parser("generate-witness")
    p.add_argument("--circuit", required=True, help=".circom source")
    p.add_argument("--input", required=True, help="input.json")
    p.add_argument("--link-library", nargs="*", default=[],
                   help="include search dirs (circomlib etc.)")
    p.add_argument("--curve", choices=["BN254", "BLS12-381"], default="BN254")
    p.add_argument("--sym", help="circom .sym file: map witness onto the "
                                 "simplified (-O1/-O2) wire order")
    p.add_argument("--protocol", choices=["PLAIN", "REP3"], default="PLAIN")
    p.add_argument("--config", help="network TOML (REP3 over TCP)")
    p.add_argument("--local-parties", type=int, default=0,
                   help="run all parties in-process (REP3 testing)")
    p.add_argument("--out", default="witness.wtns")
    p.set_defaults(fn=cmd_generate_witness)

    p = sub.add_parser("generate-proof")
    p.add_argument("proof_system", choices=["groth16", "plonk"])
    p.add_argument("--zkey", required=True)
    p.add_argument("--witness", nargs="+", required=True,
                   help="one .shared file (or all of them with --local-parties)")
    p.add_argument("--config", help="network TOML (my_id, parties)")
    p.add_argument("--local-parties", type=int, default=0)
    p.add_argument("--out", default="proof.json")
    p.add_argument("--public-input")
    p.set_defaults(fn=cmd_generate_proof)

    p = sub.add_parser("translate-witness")
    p.add_argument("--witness", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_translate_witness)

    p = sub.add_parser("verify")
    p.add_argument("proof_system", choices=["groth16", "plonk"])
    p.add_argument("--vk", required=True)
    p.add_argument("--proof", required=True)
    p.add_argument("--public-input", required=True)
    p.set_defaults(fn=cmd_verify)

    for p in sub.choices.values():
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (cuda, or cpu on a "
                            "machine without a card)")

    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
