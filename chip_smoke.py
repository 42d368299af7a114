#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (cosnarks_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:
  1. build the kernels from cosnarks_tpu_torch/csrc (nvcc, sm_90a): K1-K6,
     each for fields of 8 and of 12 32-bit words;
  2. hold every kernel mode against its plain PyTorch version at main-path
     shapes (exact limb equality), timed on the device beside its bound
     (the plain version with its host launch overhead): K1 at 3, 2^15,
     2^17 and 2^20 products, K2 at 1, 3 and 2^14 points, K3's four modes at
     1, 32 and 2^14 points (edge lanes included), K4's two modes at the
     proofs' L = 40960, 2560 and 160 fold lanes and at L = 160 on edge flag
     patterns, K5 unmasked and masked at 1, 32, 2^14, 2^17 and 2^20 points
     (edge lanes included; at 1 point also a P = Q lane, masked an invalid
     one) with its registers, K6 at the 2^16 / c = 13 and 2^20 / c = 15
     window shapes and at 2^16 / c = 13 with whole
     identity segments and with every bucket equal, each on BN254 Fq / G1
     (8 words) and on BLS12-381 Fq / G1 (12 words, rows marked "w12"), and
     K6 at 12 words also at the 2^20 / c = 16 shape of phase 4c; on
     Grumpkin (BN254 Fr, b = -17, rows marked "grumpkin"): K2 at 1 and 2^14
     points, K3's four modes at 1, 32 and 2^14, K4's two modes at L = 2560
     and 160, K6 at 2^16 / c = 13 and with every bucket equal; call K5
     through its entry point curve.madd (a broadcast affine Q, a bool
     mask), and show that a wrapper raises on a bad CUDA input instead of
     falling back, K6 on a bucket width that is not a power of two;
  3. the main path, flagship_groth16_2p20: cosnarks_tpu_torch.flagship's
     domain-2^20 synthetic zkey (2^20 - 2 constraints), then its 3-party
     Rep3 BN254 Groth16 over run_parties, once (the card warm from phase
     2); every party returns the same proof, it verifies, and every 8-word
     K1-K4 prover mode launched during the prove; the phase line carries
     the zkey's and the prove's seconds, each party's phase seconds, peak
     device memory, the launch-size histogram of each prover mode and K4's
     launches by exact (L, K); then the domain-2^16 zkey of phases 3b
     and 3c;
  3b. the 3-party Shamir (n = 3, t = 1) Groth16 prover on the 2^16 zkey,
     once (warm card and caches): the same checks, with its own counts;
  3c. the co-circom path on the 2^16 zkey: its squaring chain written as
     circom (setup.chain_circom, 2^16 - 2 constraints), the input split by
     split_input_rep3, the 3-party Rep3 witness extension (vm/), each
     party's witness Montgomery-encoded on the card by
     to_shared_witness_file (K1) into a .shared file, read back and
     proved by the Rep3 prover once: every party the same proof, it
     verifies, the witness opened from the three files equals the zkey's,
     K1 launched in to_shared_witness_file and every prover mode in the
     proof; the line carries VM, file and prove seconds, the wall time,
     each party's reshare rounds and the launch counts;
  3c'. cli_tcp_groth16: the same pipeline on a 2^15 zkey (cut from 2^16
     to make room for the 2^20 main path) through the CLI as separate
     processes (python -m cosnarks_tpu_torch), the zkey, its verifying
     key and the circuit written to files: split-input, three
     generate-witness --protocol REP3 processes at once over plaintext
     TCP, three generate-proof groth16 processes at once over TLS (the
     keys of examples/configs/tls), verify (exit 0) and verify with a
     changed public input (exit 1); the witness opened from the .shared
     files must be the zkey's and the three proof files byte-identical;
     the line carries each stage's seconds, each party's phase timings
     and bytes a peer, beside phase 3c's in-process VM and prove seconds
     (at 2^16);
  3d. the same Rep3 prover over BLS12-381 at domain 2^16, once: a
     BLS12-381 synthetic zkey, every party the same proof, verified by
     verify_bls12_381, every 12-word K1-K4 prover mode and K1 at 8 words
     (Fr) launched during the prove;
  3e. co-PLONK through the port's artifact IO: a domain-2^16 BN254 PLONK
     zkey of scripts/torch_plonk_fixture.py (squaring chain, two public
     inputs, four snarkjs additions) read by parse_plonk_zkey, each party's
     witness through split_witness_rep3 -> .shared bytes ->
     read_shared_witness, then the 3-party Rep3 PLONK prover twice: every
     party the same proof, verified by plonk.verify, per-party round
     seconds, peak device memory and every 8-word prover mode launched
     during the warm prove;
  3f. the same zkey through split_witness_shamir and the 3-party Shamir
     (n = 3, t = 1) PLONK prover once, the same checks; then one Shamir
     pair refill of the size round 3 burns (18 x 4n pairs), timed, with
     its peak device memory;
  3g. rep3_noir_honk, coNoir: a synthetic Noir program of 2^16 rows
     (noir/synthetic.py: AssertZero chains, Poseidon2, 32-bit RANGE,
     AND / XOR, ROM reads) written as a real artifact file and read back;
     its private input Rep3-shared; the CRS made on the card by
     local_crs(2^16, device=cuda) (K2); the 3-party co-ACVM and MPC
     UltraBuilder (host Python, taking turns), each party's proving key
     and vk (commitments by msm()), split_builder_pk, then co_prove
     (Keccak) once (twice before the CLI phase 3h joined the smoke's
     time); the plain pipeline proves the same program in both
     flavors on the card and verifies on the host. Every party's proof is
     the same and equals the plain Keccak proof word for word, the opened
     witness equals the plain one, a changed word is refused, one
     commitment of the co-proof equals the host Pippenger on the
     opened coefficients, and K1, K3 and K4 launched in the proof;
     the line carries each stage's seconds, the co-prover's parts a
     party, rounds a party, launches and peak device memory;
  3h. cli_tcp_noir, the same program and plain witness through the coNoir
     CLI as separate processes (python -m cosnarks_tpu_torch.noir): prove
     (Keccak) beside split-proving-key REP3 and SHAMIR, then at once
     three generate-proof --protocol REP3 processes over TLS, three
     --protocol SHAMIR (n = 3, t = 1) over plaintext TCP, verify and verify
     of a changed proof; the CLI's plain proof and the six co-proof files are
     byte-identical to 3g's plain Keccak proof, verify exits 0 then 1, and
     every generate-proof process launched each 8-word K1-K4 mode of 3g's
     co-proof; the line carries each stage's seconds, each party's phases,
     bytes a peer, rounds, Shamir pair refills and peak device memory;
  3i. multidevice: entry()'s step (two sparse matvecs, three odd-coset
     shifts) on the card equal limb for limb to the same step on the CPU,
     then dryrun_multichip(1) over NCCL with 2^16 points a rank (its msm()
     runs K4 and K3), checked against the host curve; K1-K4 launched;
  4. a 2^20-point G1 MSM at c = 15 over points [k_i]G made on the card,
     checked against the host's [sum s_i k_i]G;
  4b. the same MSM through the other split, _host_horner(_pippenger_wsums):
     K4 and the K6 weighted bucket reduction on the card, Horner on the host;
     then ten pairs of it and msm(), taking turns at going first;
  4c. the same two splits on 2^20 BLS12-381 G1 points at c = 16 (16
     windows x 32768 buckets; c = 15 overflows the top signed digit of a
     255-bit scalar), K4 and K6 at 12 words, both checked against the
     host, then three pairs taking turns;
  5. main_path_loss: K1-K3's prover modes timed (and checked) at every
     launch-size bucket of the seven proofs, K4's at every (L, K) they
     launched, each at its width, and each mode's loss per proof, sum of
     launches x (ms - bound);
  6. the kernel table (every mode of K1-K6 at every checked shape and
     width, each with its launches, the phase that counted them and its
     main-path loss, and its launches and loss in each of the seven
     proofs);
     then the card's name and power limit; then
     {"ok": true, "device": {...}} as the last line.
Imports nothing of JAX or the JAX package; needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SMS, IMAD_PER_CLOCK = 132, 64  # 32-bit integer multiplies per SM per clock
# the main path's phase, flagship.py's 3-party Rep3 BN254 Groth16 at 2^20:
# the 8-word prover modes read their launches from it
BN_PHASE, BLS_PHASE = "flagship_groth16_2p20", "bls12_381_rep3_groth16"
FLAGSHIP_LOGN = 20
# the depth of phase 3c' (cli_tcp_groth16), cut from 2^16 to make room for
# the main path at 2^20 inside the smoke's time (PERF.md lists the cuts)
CUT_LOGN = 15
CIRCOM_PHASE = "rep3_circom_groth16"
NOIR_PHASE = "rep3_noir_honk"
PROOFS = (BN_PHASE, "shamir_groth16", CIRCOM_PHASE, BLS_PHASE, "rep3_plonk",
          "shamir_plonk", NOIR_PHASE)
# K6's window shapes (windows, buckets, name) at each width: 2^16 points at
# c = 13, 2^20 at c = 15, and at 12 words 2^20 at c = 16 (phase 4c)
K6_SHAPES = {8: ((20, 4096, "2^16/c=13"), (17, 16384, "2^20/c=15")),
             12: ((20, 4096, "2^16/c=13"), (17, 16384, "2^20/c=15"),
                  (16, 32768, "2^20/c=16"))}
# Grumpkin's rows: the shapes checked a kernel (K1 is the field's, BN254
# Fr's, and no kernel of the path runs Grumpkin), and their mark
GRUMPKIN_TAG = " grumpkin"
GRUMPKIN_SHAPES = {"K2": ("1", "2^14"),
                   "K3": ("1", "1 (valid)", "32", "2^14"),
                   "K4": ((2560, None), (160, None)),
                   "K6": ("2^16/c=13", "all equal")}
# the phases that run K6 through the wsums split, by (words, W)
WSUMS_PHASES = {(8, 16384): "msm_wsums_2^20",
                (12, 32768): "msm_wsums_2^20 w12"}


class Width:
    """A field width the kernels are built for, with the curve whose G1
    checks it: 8 words on BN254, 12 on BLS12-381; and Grumpkin (8 words of
    BN254 Fr, b = -17: the kernels' negated 3b chain), whose rows are marked
    "grumpkin" and which no proof runs."""

    def __init__(self, g1, gen, dev, tag=None):
        self.g1, self.F = g1, g1.ops.field
        self.n = self.F.nlimbs
        self.words = self.n // 2
        if tag is None:  # in mode names
            tag = "" if self.words == 8 else " w12"
        self.tag = tag
        self.proof = (None if tag == GRUMPKIN_TAG else BN_PHASE
                      if self.words == 8 else BLS_PHASE)
        # one element at the int64 limb boundary; 32-bit multiplies of one
        # CIOS product (NW x NW products of a and b, NW x NW of m and p,
        # each a lo and a hi multiply, and NW m's): 264 and 588
        self.limb_bytes = 8 * self.n
        self.muls = 4 * self.words ** 2 + self.words
        top = (self.F.p >> (16 * (self.n - 1))).bit_length()
        self.top_mask = (1 << (top - 1)) - 1  # top limb below p's
        self.gen, self.dev = gen, dev

    def rand_fe(self, *shape):
        """Random canonical limbs (top limb below p's top bit)."""
        import torch

        x = torch.randint(0, 1 << 16, shape + (self.n,), generator=self.gen,
                          device=self.dev, dtype=torch.int64)
        x[..., self.n - 1] &= self.top_mask
        return x


def pow2(n: int) -> str:
    """'2^k' for a power of two above 1, else the number."""
    return f"2^{n.bit_length() - 1}" if n > 1 and n & (n - 1) == 0 \
        else str(n)


def emit(obj):
    """Print one JSON line; a phase line also carries `at_s`, the seconds
    since the script started, so each phase's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def count_calls(net, names) -> dict:
    """Count the calls of each net.<name> into the returned dict. The
    counters are instance attributes over the methods, so the base class's
    reshare_backward counts its recv too; `del net.<name>` restores one."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def wrapper(*args, _orig=getattr(net, name), _name=name, **kw):
            calls[_name] += 1
            return _orig(*args, **kw)
        setattr(net, name, wrapper)
    return calls


def cli_tcp_groth16(zkey, w, required) -> dict:
    """The co-circom pipeline as its users run it: every stage a CLI process
    (python -m cosnarks_tpu_torch), the parties three processes at once on
    one card. The zkey's squaring chain as circom and its input are split
    (split-input), the witness extended by three REP3 processes over
    plaintext TCP (generate-witness), proved by three processes over TLS
    with the keys of examples/configs/tls (generate-proof groth16) and
    verified (verify groth16) beside a verify refusing a changed public input.
    Fails unless every process exits as it should, the witness opened from
    the three .shared files is the zkey's and the three proof files are
    byte-identical, and unless every generate-witness process launched K1
    and every generate-proof process each (wrapper, key) of `required`
    (the launch counts each prints). Returns the phase line's fields."""
    from cosnarks_tpu_torch.groth16 import prove, setup
    from cosnarks_tpu_torch.io import jsonio, shared
    from cosnarks_tpu_torch.io import zkey as zkey_io
    from cosnarks_tpu_torch.mpc import rep3
    from torch_cli_procs import party_configs, run_cli

    n_inst = zkey.n_public + 1
    tls_dir = os.path.join(ROOT, "examples", "configs", "tls")
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        t0 = time.perf_counter()
        with open(path("chain.circom"), "w") as fh:
            fh.write(setup.chain_circom(zkey.n_vars - n_inst))
        with open(path("input.json"), "w") as fh:
            json.dump({"x": str(w[1])}, fh)
        with open(path("chain.zkey"), "wb") as fh:
            fh.write(zkey_io.write_groth16_zkey(zkey))
        with open(path("vk.json"), "w") as fh:
            fh.write(jsonio.vkey_to_json(prove.vk_from_zkey(zkey)))
        t_files = time.perf_counter() - t0
        zkey_bytes = os.path.getsize(path("chain.zkey"))

        split = run_cli([["split-input", "--input", path("input.json"),
                          "--out-dir", tmp]], tmp, "split")
        tcp = party_configs(tmp, "tcp", None)
        wit = run_cli([["generate-witness", "--protocol", "REP3",
                        "--circuit", path("chain.circom"), "--input",
                        path(f"input.json.{i}.shared"), "--config", tcp[i],
                        "--out", path(f"witness.{i}.shared")]
                       for i in range(3)], tmp, "generate-witness")
        files = []
        for i in range(3):
            with open(path(f"witness.{i}.shared"), "rb") as fh:
                files.append(shared.read_shared_witness(fh.read(),
                                                        device="cpu"))
        if [f.public_inputs for f in files] != [w[:n_inst]] * 3 or \
                rep3.combine_field_elements(zkey.fr, [rep3.Share(
                    f.share_a, f.share_b) for f in files]) != w[n_inst:]:
            raise AssertionError("cli_tcp_groth16: the witness opened from "
                                 "the .shared files differs from the zkey's")
        del files
        tls = party_configs(tmp, "tls", tls_dir)
        proof = run_cli([["generate-proof", "groth16", "--zkey",
                          path("chain.zkey"), "--witness",
                          path(f"witness.{i}.shared"), "--config", tls[i],
                          "--out", path(f"proof.{i}.json"), "--public-input",
                          path(f"public.{i}.json")] for i in range(3)],
                        tmp, "generate-proof")
        proof_bytes = []
        for i in range(3):
            with open(path(f"proof.{i}.json"), "rb") as fh:
                proof_bytes.append(fh.read())
        identical = proof_bytes[0] == proof_bytes[1] == proof_bytes[2]
        if not identical:
            raise AssertionError("cli_tcp_groth16: the parties' proof files "
                                 "differ")
        with open(path("public.0.json")) as fh:
            if jsonio.public_from_json(fh.read()) != w[1:n_inst]:
                raise AssertionError("cli_tcp_groth16: public.0.json is not "
                                     "the zkey's public input")
        verify_argv = ["verify", "groth16", "--vk", path("vk.json"),
                       "--proof", path("proof.0.json"), "--public-input"]
        with open(path("public.bad.json"), "w") as fh:
            fh.write(jsonio.public_to_json([(w[1] + 1) % zkey.fr.p]
                                           + w[2:n_inst]))
        ok, bad = run_cli([verify_argv + [path("public.0.json")],
                           verify_argv + [path("public.bad.json")]], tmp,
                          "verify", expect=[0, 1])
    for stage_name, runs, need in (("generate-witness", wit,
                                    [("mul", "8w:0")]),
                                   ("generate-proof", proof, required)):
        for i, r in enumerate(runs):
            missing = [n for n in need
                       if not r["launches"].get(n[0], {}).get(n[1])]
            if missing:
                raise AssertionError(f"cli_tcp_groth16: {stage_name} party "
                                     f"{i} launched no {missing}: "
                                     f"{r['launches']}")
    if ok["stdout"].strip() != "verification: OK" or \
            bad["stdout"].strip() != "verification: FAILED":
        raise AssertionError("cli_tcp_groth16: verify said "
                             f"{ok['stdout']!r} / {bad['stdout']!r}")

    def stage(runs):
        return {"wall_s": max(r["seconds"] for r in runs),
                "process_s": [r["seconds"] for r in runs],
                "phases_ms_by_party": [r["phases_ms"] for r in runs],
                "net_bytes_by_party": [r["net_bytes_by_peer"] for r in runs],
                "launches_by_party": [r["launches"] for r in runs]}

    return {"constraints": zkey.n_vars - n_inst, "zkey_bytes": zkey_bytes,
            "write_files_s": t_files,
            "stages": {"split-input": stage(split),
                       "generate-witness (REP3, TCP)": stage(wit),
                       "generate-proof (groth16, TLS)": stage(proof),
                       "verify, beside verify with a changed public "
                       "input": stage([ok, bad])},
            "tcp_vm_ms_by_party": [r["phases_ms"].get("Witness extension")
                                   for r in wit],
            "tls_prove_ms_by_party": [r["phases_ms"].get("Generate proof")
                                      for r in proof],
            "witness_matches_zkey": True, "proofs_identical": identical,
            "verify_ok_exit": 0, "verify_changed_exit": 1}


def cli_tcp_noir(program, wmap, plain_proof, required) -> dict:
    """The coNoir pipeline as its users run it: every stage a CLI process
    (python -m cosnarks_tpu_torch.noir), the parties three processes at
    once on one card. The program (`synthetic.synthetic_program(**program)`)
    and its plain witness stack `wmap` are written to a temporary
    directory; `prove` (Keccak) and split-proving-key REP3 and SHAMIR run
    at once; then, all at once, three generate-proof --protocol REP3
    processes over TLS with the keys of examples/configs/tls, three
    --protocol SHAMIR processes (n = 3, t = 1) over plaintext TCP, verify
    (exit 0) and verify of a proof with one word changed (exit 1): the
    co-provers wait on their peers far more than they use the card, so
    the stages overlap (scripts/torch_noir_cli_overlap.py measures both
    orders). Fails unless every process exits as it should, the CLI's
    plain proof and public inputs are `plain_proof`'s bytes, the six
    co-proof files are byte-identical to them, and every generate-proof
    process launched each (wrapper, key) of `required` (the launch counts
    each prints). Returns the phase line's fields."""
    from cosnarks_tpu_torch.honk import transcript
    from cosnarks_tpu_torch.honk.polyops import R
    from cosnarks_tpu_torch.noir import acir, synthetic
    from torch_cli_procs import party_configs, run_cli

    H = transcript.HASHERS["keccak"]
    want = (H.to_buffer(plain_proof[0]), H.to_buffer(plain_proof[1]))
    tls_dir = os.path.join(ROOT, "examples", "configs", "tls")

    def cli(argvs, tmp, stage, expect=0):
        return run_cli(argvs, tmp, stage, expect=expect,
                       module="cosnarks_tpu_torch.noir")

    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        def read(name):
            with open(path(name), "rb") as fh:
                return fh.read()

        t0 = time.perf_counter()
        acir.dump_artifact(path("program.json"),
                           *synthetic.synthetic_program(**program))
        acir.write_witness_stack(path("witness.gz"), wmap)
        t_files = time.perf_counter() - t0
        given = ["--circuit", path("program.json"), "--witness",
                 path("witness.gz")]
        keccak = ["--hasher", "KECCAK"]
        first = cli([["prove", *given, "--out", path("proof"),
                      "--public-input", path("public"), "--vk", path("vk"),
                      *keccak]]
                    + [["split-proving-key", *given, "--out-dir", path(p),
                        "--protocol", p] for p in ("REP3", "SHAMIR")],
                    tmp, "prove+split-proving-key")
        if (read("proof"), read("public")) != want:
            raise AssertionError("cli_tcp_noir: the CLI's plain proof is not "
                                 "the in-process plain proof")
        bad = list(plain_proof[0])
        bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % R
        with open(path("proof.bad"), "wb") as fh:
            fh.write(H.to_buffer(bad))
        verify = ["verify", "--public-input", path("public"), "--vk",
                  path("vk"), *keccak, "--proof"]
        argvs = []
        for proto, cfg in (("REP3", party_configs(tmp, "tls", tls_dir)),
                           ("SHAMIR", party_configs(tmp, "tcp", None))):
            argvs += [[
                "generate-proof", "--protocol", proto, "--proving-key",
                path(f"{proto}/pk.{i}.shared"), "--proving-key-public",
                path(f"{proto}/pk_public.npz"), "--config", cfg[i], "--out",
                path(f"{proto}.proof.{i}"), "--public-input",
                path(f"{proto}.public.{i}"), *keccak] for i in range(3)]
        rs = cli(argvs + [verify + [path("proof")],
                          verify + [path("proof.bad")]], tmp,
                 "generate-proof REP3 and SHAMIR, verify",
                 expect=[0] * 6 + [0, 1])
        runs = {"REP3": rs[:3], "SHAMIR": rs[3:6]}
        ok, refused = rs[6:]
        for proto in runs:
            for i in range(3):
                if (read(f"{proto}.proof.{i}"),
                        read(f"{proto}.public.{i}")) != want:
                    raise AssertionError(f"cli_tcp_noir: {proto} party {i}'s "
                                         "proof is not the plain proof")
    for proto, rs in runs.items():
        for i, r in enumerate(rs):
            missing = [n for n in required
                       if not r["launches"].get(n[0], {}).get(n[1])]
            if missing:
                raise AssertionError(f"cli_tcp_noir: {proto} party {i} "
                                     f"launched no {missing}: "
                                     f"{r['launches']}")
    if ok["stdout"].strip() != "verified" or \
            refused["stdout"].strip() != "verification FAILED":
        raise AssertionError("cli_tcp_noir: verify said "
                             f"{ok['stdout']!r} / {refused['stdout']!r}")

    def stage(rs):
        return {"wall_s": max(r["seconds"] for r in rs),
                "process_s": [r["seconds"] for r in rs],
                "phases_ms_by_party": [r["phases_ms"] for r in rs],
                "net_bytes_by_party": [r["net_bytes_by_peer"] for r in rs],
                "counts_by_party": [r["counts"] for r in rs],
                "launches_by_party": [r["launches"] for r in rs]}

    return {"program": program, "write_files_s": t_files,
            "stages": {"prove + split-proving-key REP3, SHAMIR": stage(first),
                       "generate-proof (REP3, TLS)": stage(runs["REP3"]),
                       "generate-proof (SHAMIR, TCP)": stage(runs["SHAMIR"]),
                       "verify, verify of a changed proof": stage(
                           [ok, refused])},
            "stages_at_once": ["generate-proof (REP3, TLS)",
                               "generate-proof (SHAMIR, TCP)",
                               "verify, verify of a changed proof"],
            "co_prove_ms_by_party": {
                p: [r["phases_ms"].get("Generate proof") for r in rs]
                for p, rs in runs.items()},
            "peak_device_bytes_by_party": {
                p: [r["counts"].get("peak_device_bytes") for r in rs]
                for p, rs in runs.items()},
            "rounds_by_party": {p: [r["counts"].get("rounds") for r in rs]
                                for p, rs in runs.items()},
            "shamir_pair_refills_by_party": [
                r["counts"].get("pair_refills") for r in runs["SHAMIR"]],
            "proofs_identical": True, "verify_ok_exit": 0,
            "verify_changed_exit": 1}


def multidevice_phase(dev) -> dict:
    """`multidevice.entry()`'s step on the card held limb for limb to the
    same step on the CPU (the kernels' plain versions), then
    `dryrun_multichip(1)` over NCCL with 2^16 points a rank, so that its
    msm() runs K4 and K3; the dry run checks itself against the host
    curve. Returns the phase line's fields."""
    import torch

    from cosnarks_tpu_torch import multidevice

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, args = multidevice.entry(dev)
    out = step(*args)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    cpu_step, cpu_args = multidevice.entry("cpu")
    if not torch.equal(out.cpu(), cpu_step(*cpu_args)):
        raise AssertionError("multidevice: entry() on the card != on the CPU")
    t0 = time.perf_counter()
    ranks = multidevice.dryrun_multichip(1, dev, points_per_rank=1 << 16,
                                         timeout_s=300)
    torch.cuda.synchronize()
    return {"entry_step_s": t_step, "entry_equals_cpu": True,
            "dryrun_s": time.perf_counter() - t0, "ranks": ranks,
            "backend": "nccl", "msm_points_per_rank": 1 << 16}


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import cosnarks_tpu_torch as ct  # fails outside a checkout of the repo
    from cosnarks_tpu_torch import _build, flagship
    from cosnarks_tpu_torch.ec import curve as ec
    from cosnarks_tpu_torch.ec import ec_kernels as ek
    from cosnarks_tpu_torch.ec import host, msm
    from cosnarks_tpu_torch.ec.curves import BLS12_381_G1, BN254_G1, GRUMPKIN
    from cosnarks_tpu_torch.ff import mont, mont_kernel
    from cosnarks_tpu_torch.ff.mont_kernel import key_str
    from cosnarks_tpu_torch.groth16 import drivers, prove, setup
    from cosnarks_tpu_torch.groth16.verify import (verify_bls12_381,
                                                   verify_bn254)
    from cosnarks_tpu_torch.io import shared
    from cosnarks_tpu_torch.mpc import rep3, shamir
    from cosnarks_tpu_torch.mpc.net.local import run_parties
    from cosnarks_tpu_torch.plonk import drivers as plonk_drivers
    from cosnarks_tpu_torch.plonk import prove as plonk_prove
    from cosnarks_tpu_torch.utils import timing
    from cosnarks_tpu_torch.vm import lang, mpc_run
    from cosnarks_tpu_torch.vm.interp import PlainDriver
    from cosnarks_tpu_torch.vm.rep3_driver import Rep3Driver
    from cosnarks_tpu_torch.mpc.rep3_scalar import HostRng, Rep3Scalar
    from cosnarks_tpu_torch.noir import acir as nacir
    from cosnarks_tpu_torch.noir import solver as nsolver
    from cosnarks_tpu_torch.noir import synthetic
    from cosnarks_tpu_torch.honk import builder as hbuilder
    from cosnarks_tpu_torch.honk import co_prover as hco
    from cosnarks_tpu_torch.honk import crs as hcrs
    from cosnarks_tpu_torch.honk import polyops as hpolyops
    from cosnarks_tpu_torch.honk import prover as hprover
    from cosnarks_tpu_torch.honk import proving_key as hpk
    from cosnarks_tpu_torch.honk import transcript as htranscript
    from cosnarks_tpu_torch.honk import verifier as hverifier
    from cosnarks_tpu_torch.honk.co_driver import Rep3HonkDriver
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_plonk_fixture import rep3_plonk_case

    dev = torch.device("cuda")
    ct.set_default_device(dev)
    card = smi("name,power.limit")
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "card": card,
          "builds": [f"{k} ({w} words)" for k, w in _build.builds()],
          "registers": {k + ("" if w == 8 else " (12 words)"):
                        _build.resource_usage(k, w)
                        for k, w in _build.builds()}})

    # ---- phase 2: kernels against their plain versions -------------------
    gen = torch.Generator(device=dev).manual_seed(0xC05)
    W8, W12 = Width(BN254_G1, gen, dev), Width(BLS12_381_G1, gen, dev)
    WG = Width(GRUMPKIN, gen, dev, tag=GRUMPKIN_TAG)
    F = W8.F
    rand_fe = W8.rand_fe

    sleep_s = 0.05

    def timed(fn, iters, queue_ahead=False):
        """Mean ms per call between CUDA events, and the host's ms to
        enqueue them all. With queue_ahead, the calls are queued behind a
        50 ms device sleep, so while the enqueue takes less than that the
        events time the device's back-to-back runs and not the host's
        launch overhead."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(int(sleep_s * sm_clock_hz))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / iters, host_ms

    def flat(ts):
        for t in ts:
            if isinstance(t, torch.Tensor):
                yield t
            else:
                yield from flat(t)

    def max_err(a, b):
        return max(int((x - y).abs().max()) if x.numel() else 0
                   for x, y in zip(flat(a), flat(b)))

    def bound(nbytes, nmuls):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nmuls / (SMS * IMAD_PER_CLOCK * sm_clock_hz) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    # every kernel mode: the wrapper and its (words, op) key that count it,
    # and the phase whose run gives its launches (None: launched by the
    # checks alone); K1-K4 at both widths, the 12-word modes marked "w12"
    modes = {}
    for w in (W8, W12, WG):
        for name, fn, op, proved in (
                ("K1 mont_mul", mont_kernel.mul, 0, True),
                ("K2 jacobian add", ek.jacobian_launch, ek.JAC_ADD, True),
                ("K2 jacobian double", ek.jacobian_launch, ek.JAC_DOUBLE,
                 True),
                ("K3 proj add", ek.proj_launch, ek.PROJ_ADD, True),
                ("K3 proj madd", ek.proj_launch, ek.PROJ_MADD, False),
                ("K3 proj madd (masked)", ek.proj_launch,
                 ek.PROJ_MADD_MASKED, False),
                ("K3 proj double", ek.proj_launch, ek.PROJ_DOUBLE, True),
                ("K4 fold level 0", ek.fold_launch, 0, True),
                ("K4 fold projective", ek.fold_launch, 1, True)):
            key = (w.words, op) if fn is mont_kernel.mul else (
                w.words, op, w.g1.name)
            modes[name + w.tag] = (fn, key, w.proof if proved else None)
    for w in (W8, W12):
        modes["K5 jacobian madd" + w.tag] = (
            ek.madd_launch, (w.words, ek.MADD, w.g1.name), None)
        modes["K5 jacobian madd (masked)" + w.tag] = (
            ek.madd_launch, (w.words, ek.MADD_MASKED, w.g1.name), None)
        for nwin, W, shape in K6_SHAPES[w.words]:
            modes[f"K6 wreduce {shape}{w.tag}"] = (
                ek.wreduce_launch, (w.words, W, w.g1.name),
                WSUMS_PHASES.get((w.words, W)))
    modes[f"K6 wreduce 2^16/c=13{GRUMPKIN_TAG}"] = (
        ek.wreduce_launch, (8, 4096, WG.g1.name), None)
    rows = {}

    def check(name, kernel_fn, plain_fn, nbytes, nmuls, iters,
              replaces, source, shape, mode=None, **extra):
        """Time a kernel mode at one shape beside its bound (nbytes moved,
        nmuls 32-bit multiplies), hold it against its plain version and
        keep its row (with `extra`) for the kernel table."""
        out, ms, enqueue_ms = timed(kernel_fn, iters, queue_ahead=True)
        ref, plain_ms, _ = timed(plain_fn, 1)
        err = max_err(out, ref)
        bms, by = bound(nbytes, nmuls)
        row = {"name": name, "mode": mode or name, "shape": shape,
               "route": "cuda", "source": source, "replaces": replaces,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bms, "bound_by": by, "library_ms": None, **extra}
        rows[name] = row
        emit({"phase": "kernel_check", **row, "iters": iters,
              "enqueue_ms": enqueue_ms,
              "queued_within_sleep": enqueue_ms < sleep_s * 1e3})
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain version")

    K1_SITE = ("cosnarks_tpu/ff/pallas_mont.py:145 (_mul_call), :184 "
               "(_mul_call_lm)")
    K1_SRC = "cosnarks_tpu_torch/csrc/mont_mul.cu"
    K2_ADD_SITE = "cosnarks_tpu/ec/pallas_ec.py:102 (_add_call)"
    K2_DOUBLE_SITE = "cosnarks_tpu/ec/pallas_ec.py:130 (_double_call)"
    K2_SRC = "cosnarks_tpu_torch/csrc/jacobian.cu"
    K = 32

    def fold_flags(L, K, pattern=None):
        step = torch.arange(K, device=dev)[:, None]
        lanes = torch.arange(L, device=dev)[None, :]
        changed = ((step * 7 + lanes) % 5 == 0) & (step > 0)
        valid = (step + lanes) % 11 != 0
        save = changed & ((step + lanes) % 3 == 0)
        if pattern == "all changed":
            changed = torch.ones_like(changed)
        elif pattern == "all invalid":
            valid = torch.zeros_like(valid)
        elif pattern == "save-prefix on step 0":
            save = save | (step == 0)
        flags = (changed.to(torch.int64) | (valid.to(torch.int64) << 1)
                 | (save.to(torch.int64) << 2))
        return flags.contiguous(), changed, valid

    def fold_case(w, L, proj_q, K=K, pattern=None):
        """K4 at width w on random operands: (kernel_fn, plain_fn, bytes,
        32-bit multiplies); level 0 takes its operands packed."""
        fl, ch, va = fold_flags(L, K, pattern)
        q = [w.rand_fe(K, L).permute(2, 0, 1).contiguous()  # (n, K, L)
             for _ in range(3 if proj_q else 2)]
        qk = q if proj_q else [(c[0::2] | (c[1::2] << 16)).contiguous()
                               for c in q]
        nmuls = (12 * int((~ch).sum()) if proj_q
                 else 11 * int((~ch & va).sum()))
        nbytes = (sum(c.numel() for c in qk) + K * L + 3 * w.n * K * L
                  + 6 * w.n * L) * 8
        return (lambda: ek.fold_launch(w.g1, qk, fl, K, proj_q),
                lambda: ek.fold_plain(w.g1, tuple(q), fl, K, proj_q),
                nbytes, nmuls * w.muls)

    def check_k1_k4(w, shapes=None):
        """K1-K4 at width w against their plain versions at the main path's
        shapes, edge lanes and flag patterns included; with `shapes`, only
        the kernels and shapes it names (GRUMPKIN_SHAPES)."""
        F, g1, tag, eb = w.F, w.g1, w.tag, w.limb_bytes
        n0 = w.n

        def want(kernel, shape):
            return shapes is None or shape in shapes.get(kernel, ())

        # K1 at the main path's batch sizes: 3 products (one Fq2 product
        # of a G2 point op), 2^15 (an NTT butterfly stage of one share
        # component at domain 2^16), 2^17 (the Fq2 products of a G2 MSM
        # level-0 step) and 2^20 (the table's shape)
        n1 = 1 << 20
        a, b = w.rand_fe(n1), w.rand_fe(n1)
        for n, iters in ((3, 200), (1 << 15, 200), (1 << 17, 50), (n1, 20)):
            if not want("K1", pow2(n)):
                continue
            x, y = a[:n], b[:n]
            check(f"K1 mont_mul{tag} {pow2(n)}",
                  lambda x=x, y=y: (mont_kernel.mul(F, x, y),),
                  lambda x=x, y=y: (mont.mul_plain(F, x, y),),
                  3 * n * eb, n * w.muls, iters, K1_SITE, K1_SRC,
                  shape=[n, n0], mode=f"K1 mont_mul{tag}")
        del a, b

        # K2 / K3 at 2^14 points with infinity, P = Q and P = -Q lanes
        # mixed in (lane mod 8: 1 P = Q, 2 P = -Q, 3 P = inf, 4 Q = inf)
        n2 = 1 << 14
        P = [w.rand_fe(n2) for _ in range(3)]
        Q = [w.rand_fe(n2) for _ in range(3)]
        lane = torch.arange(n2, device=dev)
        for c in range(3):  # P = Q on lanes 1 mod 8
            Q[c] = torch.where((lane % 8 == 1)[:, None], P[c], Q[c])
        Q[1] = torch.where((lane % 8 == 2)[:, None], mont.neg(F, P[1]),
                           Q[1])
        Q[0] = torch.where((lane % 8 == 2)[:, None], P[0], Q[0])
        Q[2] = torch.where((lane % 8 == 2)[:, None], P[2], Q[2])
        P[2] = torch.where((lane % 8 == 3)[:, None], torch.zeros_like(P[2]),
                           P[2])  # P = inf
        Q[2] = torch.where((lane % 8 == 4)[:, None], torch.zeros_like(Q[2]),
                           Q[2])  # Q = inf
        P = [x.contiguous() for x in P]
        Q = [x.contiguous() for x in Q]
        finite = ((lane % 8 != 3) & (lane % 8 != 4))
        same = lane % 8 == 1
        # K2 at the main path's single points (scalar_mul: one ordinary
        # lane, one P = Q lane), at 3 points (Shamir's batched scalar mul:
        # lanes 0-2, ordinary, P = Q, P = -Q) and at 2^14 points with every
        # edge lane
        for label, sl, iters in (("1", slice(0, 1), 200),
                                 ("1 (P = Q)", slice(1, 2), 200),
                                 ("3", slice(0, 3), 200),
                                 ("2^14", slice(0, n2), 20)):
            if not want("K2", label):
                continue
            Ps, Qs = [x[sl] for x in P], [x[sl] for x in Q]
            n = Ps[0].shape[0]
            add_muls = int(finite[sl].sum()) * 16 + int(same[sl].sum()) * 7
            check(f"K2 jacobian add{tag} {label}",
                  lambda Ps=Ps, Qs=Qs: ek.jacobian_launch(g1, ek.JAC_ADD,
                                                          Ps + Qs),
                  lambda Ps=Ps, Qs=Qs: ek.add_plain(g1, tuple(Ps),
                                                    tuple(Qs)),
                  9 * n * eb, add_muls * w.muls, iters, K2_ADD_SITE, K2_SRC,
                  shape=[n, n0], mode=f"K2 jacobian add{tag}")
        # the double at 1 ordinary point, at 3 (lanes 2-4, P = inf on lane
        # 3) and at 2^14
        for label, sl, iters in (("1", slice(0, 1), 200),
                                 ("3 (P = inf)", slice(2, 5), 200),
                                 ("2^14", slice(0, n2), 20)):
            if not want("K2", label):
                continue
            Ps = [x[sl] for x in P]
            n = Ps[0].shape[0]
            check(f"K2 jacobian double{tag} {label}",
                  lambda Ps=Ps: ek.jacobian_launch(g1, ek.JAC_DOUBLE, Ps),
                  lambda Ps=Ps: ek.double_plain(g1, tuple(Ps)),
                  6 * n * eb, 7 * n * w.muls, iters, K2_DOUBLE_SITE, K2_SRC,
                  shape=[n, n0], mode=f"K2 jacobian double{tag}")
        # K3 in every mode at 1 point, at 32 (lanes 0-31: every edge lane)
        # and at 2^14, on projective points: (0 : 1 : 0) on P's lanes 3 mod
        # 8 and Q's lanes 4 mod 8, P = Q on lanes 1 mod 8, P = -Q on lanes
        # 2 mod 8; the masked madd drops lanes 0 mod 4, so its 1-point case
        # is also run on lane 1 (valid, P = Q), where the madd's layers run
        one2 = mont.broadcast_one(F, (n2,), device=dev)
        ident = (torch.zeros_like(one2), one2, torch.zeros_like(one2))
        PP = [torch.where((lane % 8 == 3)[:, None], i, x).contiguous()
              for x, i in zip(P, ident)]
        QQ = [torch.where((lane % 8 == 4)[:, None], i, x).contiguous()
              for x, i in zip(Q, ident)]
        valid = (lane % 4 != 0).to(torch.int64).contiguous()
        k3_site = "cosnarks_tpu/ec/pallas_ec.py:536 (_proj_op_call, {})"
        k3_modes = (  # name, op, formula, coordinates moved, field products
            ("K3 proj add", ek.PROJ_ADD, "add", 9, 12),
            ("K3 proj madd", ek.PROJ_MADD, "madd", 8, 11),
            ("K3 proj madd (masked)", ek.PROJ_MADD_MASKED, "madd", 8, 11),
            ("K3 proj double", ek.PROJ_DOUBLE, "double", 6, 8),
        )
        for name, op, formula, ncoords, nmuls in k3_modes:
            masked = op == ek.PROJ_MADD_MASKED
            k3_shapes = [("1", slice(0, 1), 200), ("32", slice(0, 32), 200),
                         ("2^14", slice(0, n2), 20)]
            if masked:
                k3_shapes.insert(1, ("1 (valid)", slice(1, 2), 200))
            for label, sl, iters in k3_shapes:
                if not want("K3", label):
                    continue
                Ps, Qs = [x[sl] for x in PP], [x[sl] for x in QQ]
                vs = valid[sl]
                n = Ps[0].shape[0]
                vm = vs if masked else None
                ins = Ps + (Qs if op == ek.PROJ_ADD
                            else [] if op == ek.PROJ_DOUBLE else Qs[:2])
                plain = {
                    "add": lambda Ps=Ps, Qs=Qs: ek.proj_add_plain(
                        g1, tuple(Ps), tuple(Qs)),
                    "madd": lambda Ps=Ps, Qs=Qs, vm=vm: ek.proj_madd_plain(
                        g1, tuple(Ps), tuple(Qs[:2]),
                        None if vm is None else vm != 0),
                    "double": lambda Ps=Ps: ek.proj_double_plain(
                        g1, tuple(Ps)),
                }[formula]
                check(f"{name}{tag} {label}",
                      lambda op=op, ins=ins, vm=vm: ek.proj_launch(
                          g1, op, ins, vm),
                      plain,
                      ncoords * n * eb + (n * 8 if masked else 0),
                      nmuls * (int(vs.sum()) if masked else n) * w.muls,
                      iters, k3_site.format(formula),
                      "cosnarks_tpu_torch/csrc/proj_op.cu", shape=[n, n0],
                      mode=name + tag)

        # K4 in both modes at the proofs' lane counts at domain 2^16 (c =
        # 13: 20 windows x 2048, 128 and 8 chunks), and at L = 160 on edge
        # flag patterns
        for proj_q, name in ((False, "K4 fold level 0"),
                             (True, "K4 fold projective")):
            for L, pattern, iters in ((40960, None, 5), (2560, None, 20),
                                      (160, None, 20),
                                      (160, "all changed", 20),
                                      (160, "all invalid", 20),
                                      (160, "save-prefix on step 0", 20)):
                if not want("K4", (L, pattern)):
                    continue
                kernel_fn, plain_fn, nbytes, nmuls = fold_case(
                    w, L, proj_q, pattern=pattern)
                check(f"{name}{tag} L={L}"
                      + (f" ({pattern})" if pattern else ""),
                      kernel_fn, plain_fn, nbytes, nmuls, iters,
                      f"cosnarks_tpu/ec/pallas_ec.py:340 (_level0_call, "
                      f"proj_q={proj_q})",
                      "cosnarks_tpu_torch/csrc/msm_fold.cu",
                      shape=[K, L], mode=name + tag, flags=pattern or "smoke")
                del kernel_fn, plain_fn

    def check_k5(w):
        """K5 at width w at 1, 32, 2^14, 2^17 and 2^20 points, unmasked and
        masked, on a Jacobian P and an affine Q of random canonical limbs:
        P = Q (X1 = x2 Z1^2, Y1 = y2 Z1^3) on lanes 1 mod 8, P = -Q on
        lanes 2 mod 8, P = inf on lanes 3 mod 8; the masked mode drops lanes
        0 mod 4, so its 1-point case is an invalid lane, and both modes also
        run lane 1 alone (valid, P = Q: the double's layers). Returns the
        2^14-point operands (P, affine Q, mask)."""
        F, g1, n5 = w.F, w.g1, 1 << 20
        P = [w.rand_fe(n5) for _ in range(3)]
        QA = [w.rand_fe(n5).contiguous() for _ in range(2)]
        lane = torch.arange(n5, device=dev)
        Zsq = mont.mul(F, P[2], P[2])
        Xs = mont.mul(F, QA[0], Zsq)
        Ys = mont.mul(F, QA[1], mont.mul(F, Zsq, P[2]))
        same, minus = (lane % 8 == 1)[:, None], (lane % 8 == 2)[:, None]
        PJ = [torch.where(same | minus, Xs, P[0]),
              torch.where(same, Ys, torch.where(minus, mont.neg(F, Ys),
                                                P[1])),
              torch.where((lane % 8 == 3)[:, None], torch.zeros_like(P[2]),
                          P[2])]
        PJ = [x.contiguous() for x in PJ]
        del P, Zsq, Xs, Ys
        valid = (lane % 4 != 0).to(torch.int64).contiguous()
        finite = (PJ[2] != 0).any(-1)
        regs = _build.resource_usage("jacobian_madd", w.words)
        for masked in (False, True):
            mode = "K5 jacobian madd" + (" (masked)" if masked else "") + w.tag
            for label, sl, iters in (
                    ("1", slice(0, 1), 200), ("1 (P = Q)", slice(1, 2), 200),
                    ("32", slice(0, 32), 200),
                    ("2^14", slice(0, 1 << 14), 20),
                    ("2^17", slice(0, 1 << 17), 20),
                    ("2^20", slice(0, n5), 20)):
                ins = [x[sl] for x in PJ + QA]
                n = ins[0].shape[0]
                vm = valid[sl] if masked else None
                live = finite[sl] & (vm != 0) if masked else finite[sl]
                doubles = int((live & same[sl, 0]).sum())
                check(f"{mode} {label}",
                      lambda ins=ins, vm=vm: ek.madd_launch(g1, ins, vm),
                      lambda ins=ins, vm=vm: ek.madd_plain(
                          g1, tuple(ins[:3]), tuple(ins[3:]),
                          None if vm is None else vm != 0),
                      8 * n * w.limb_bytes + (n * 8 if masked else 0),
                      (11 * (int(live.sum()) - doubles) + 7 * doubles)
                      * w.muls, iters,
                      "cosnarks_tpu/ec/pallas_ec.py:157 (_madd_call"
                      + (", masked)" if masked else ")"),
                      "cosnarks_tpu_torch/csrc/jacobian_madd.cu",
                      shape=[n, w.n], mode=mode, registers=regs,
                      geometry=ek.madd_geometry(n, w.words))
        n2 = 1 << 14
        return ([x[:n2] for x in PJ], [x[:n2] for x in QA],
                valid[:n2])

    def check_k6(w, shapes=None):
        """K6 at width w at its window shapes, on random projective buckets
        with identity (0 : 1 : 0) lanes on j = 5 mod 16, and at 2^16 / c =
        13 with segments 1 and P - 1 of every window all identity and with
        every bucket the generator (a P = Q add inside each running sum;
        the result also checked against the host's (W (W + 1) / 2) G); with
        `shapes`, only the window shapes and patterns it names."""
        g1 = w.g1
        one = mont.broadcast_one(w.F, (), device=dev)
        gen_pt = ec.encode_points(g1, [g1.generator], device=dev)
        hc = host.host_curve(g1)
        cases = [(nwin, W, shape, None) for nwin, W, shape in
                 K6_SHAPES[w.words]]
        cases += [(20, 4096, "2^16/c=13", "identity segments"),
                  (20, 4096, "2^16/c=13", "all equal")]
        for nwin, W, shape, pattern in cases:
            if shapes is not None and (pattern or shape) not in shapes["K6"]:
                continue
            P, group, threads = ek.wreduce_geometry(W, w.words)
            if pattern == "all equal":
                bk = [x[0].expand(nwin, W, w.n).contiguous() for x in gen_pt]
            else:
                bk = [w.rand_fe(nwin, W) for _ in range(3)]
                j = torch.arange(W, device=dev)
                ident = j % 16 == 5
                if pattern == "identity segments":
                    seg = j // (W // P)
                    ident = ident | (seg == 1) | (seg == P - 1)
                ident = ident[None, :, None]
                bk = [torch.where(ident, torch.zeros_like(bk[0]), bk[0]),
                      torch.where(ident, one.expand_as(bk[1]), bk[1]),
                      torch.where(ident, torch.zeros_like(bk[2]), bk[2])]
                bk = [x.contiguous() for x in bk]
            # the bound counts the adds the sum needs: running sums (suffix
            # sums of S, then their sum), 2(W - 1) per window; work_done is
            # what the segmented design does
            adds = 2 * (W - 1)
            work = ek.wreduce_work(W, P)
            mode = f"K6 wreduce {shape}{w.tag}"
            check(mode + (f" ({pattern})" if pattern else ""),
                  lambda bk=bk: ek.wreduce_launch(g1, bk),
                  lambda bk=bk: ek.wreduce_plain(g1, tuple(bk)),
                  (3 * nwin * W + 3 * nwin) * w.limb_bytes,
                  nwin * 12 * adds * w.muls, 5,
                  "cosnarks_tpu/ec/pallas_ec.py:192 (_wreduce_call)",
                  "cosnarks_tpu_torch/csrc/wreduce.cu", shape=[nwin, W],
                  mode=mode, buckets=pattern or "smoke",
                  counted={"rcb_adds_per_window": adds,
                           "field_muls": nwin * 12 * adds},
                  work_done={**work, "rcb_ops_per_window": sum(
                      work.values()), "over_counted": sum(work.values())
                      / adds, "segments": P, "group": group,
                      "threads": threads})
            if pattern == "all equal":
                out = ek.wreduce_launch(g1, bk)
                got = ec.decode_points(g1, ec.proj_to_jacobian(
                    g1, tuple(x[:1] for x in out)))[0]
                if got != hc.affine_ints(hc.mul(hc.generator,
                                                W * (W + 1) // 2)):
                    raise AssertionError(f"{mode}: sum of equal buckets "
                                         "differs from the host")
            del bk

    check_k1_k4(W8)
    check_k1_k4(W12)
    torch.cuda.empty_cache()
    n2 = 1 << 14
    g1 = BN254_G1
    PJ, QA, valid = check_k5(W8)
    check_k5(W12)
    torch.cuda.empty_cache()

    # K5's entry point, curve.madd: one affine Q broadcast over the batch,
    # unmasked and with a bool mask, launches K5 and equals the plain version
    q_one = tuple(x[5:6] for x in QA)
    q_wide = tuple(x.expand_as(PJ[0]).contiguous() for x in q_one)
    before = sum(ek.madd_launch.launches.values())
    for vm in (None, valid != 0):
        err = max_err(ec.madd(g1, tuple(PJ), q_one, vm),
                      ek.madd_plain(g1, tuple(PJ), q_wide, vm))
        if err != 0:
            raise AssertionError("curve.madd differs from the plain version")
    launched = sum(ek.madd_launch.launches.values()) - before
    if launched != 2:
        raise AssertionError(f"curve.madd launched K5 {launched} times, not 2")
    emit({"phase": "curve_madd", "points": n2, "q": "one, broadcast",
          "masks": [None, "bool"], "k5_launches": launched,
          "max_abs_err": 0})
    del PJ, QA, valid, q_wide

    check_k6(W8)
    check_k6(W12)
    # Grumpkin (b = -17): K2-K4 and K6 at 8 words on BN254 Fr's constants,
    # the RCB kernels with 3b = -51 (the chain of 51, then a negation)
    check_k1_k4(WG, GRUMPKIN_SHAPES)
    check_k6(WG, GRUMPKIN_SHAPES)
    torch.cuda.empty_cache()

    # a CUDA tensor never reaches a plain version: bad inputs raise, and K6
    # refuses a bucket width that is not a power of two
    refused = []
    a = rand_fe(16)
    for bad in (a[:8].to(torch.int32), a[:16, ::2], a[:8, :8]):
        try:
            mont_kernel.mul(F, bad, bad)
        except (TypeError, ValueError) as e:
            refused.append(type(e).__name__)
    if len(refused) != 3:
        raise AssertionError("a kernel wrapper accepted a bad CUDA input")
    try:
        ek.wreduce_launch(g1, [rand_fe(1, 96)] * 3)
    except ValueError as e:
        refused.append(f"K6: {e}")
    else:
        raise AssertionError("K6 launched on 96 buckets a window")
    emit({"phase": "wrapper_refuses_bad_input", "raised": refused})
    del a
    torch.cuda.empty_cache()
    counters = (mont_kernel.mul, ek.jacobian_launch, ek.proj_launch,
                ek.fold_launch, ek.madd_launch, ek.wreduce_launch)

    def clear_counts():
        for c in counters:
            c.launches.clear()
            c.sizes.clear()
        ek.fold_launch.shapes.clear()

    def read_counts():
        """{wrapper: {"<words>w:<op>[:<curve>]": launches}}."""
        return timing.launch_counts()

    def read_sizes():
        """The launch-size histogram of every prover mode at both widths:
        {mode name: {bucket: launches}}, bucket the power of two at or
        above the launch's batch (products, points, fold lanes)."""
        return {name: {str(bk): n for (m, bk), n in sorted(fn.sizes.items())
                       if m == mode}
                for name, (fn, mode, phase) in modes.items()
                if phase in PROOFS}

    counts_by_phase, sizes_by_phase, shapes_by_phase = {}, {}, {}

    def read_shapes():
        """K4's launches by exact shape: {((words, mode, curve), L, K):
        launches}."""
        return dict(ek.fold_launch.shapes)

    def shape_names(shapes):
        return {f"{'projective' if m else 'level 0'}"
                f"{'' if nw == 8 else ' w12'} L={L} K={k}": n
                for ((nw, m, _), L, k), n in sorted(shapes.items())}

    def record(phase):
        """Keep the launch counts, sizes and K4 shapes of `phase`'s run;
        the phase line's launch fields."""
        counts_by_phase[phase] = by_op = read_counts()
        sizes_by_phase[phase] = sizes = read_sizes()
        shapes_by_phase[phase] = shapes = read_shapes()
        return {"launches": {k: sum(v.values()) for k, v in by_op.items()},
                "launches_by_mode": by_op, "launch_sizes": sizes,
                "fold_shapes": shape_names(shapes)}

    def require_launched(phase, names):
        """Fail unless every mode in `names` launched in `phase`'s run."""
        got = counts_by_phase[phase]
        missing = [n for n in names
                   if got[modes[n][0].__qualname__].get(
                       key_str(modes[n][1]), 0) == 0]
        if missing:
            raise AssertionError(f"{phase}: {missing} did not launch: {got}")

    prover_modes = [n for n, m in modes.items() if m[2] == BN_PHASE]
    # the BLS12-381 proof: G1 and Fq at 12 words, Fr (witness map, NTT) at 8
    bls_modes = [n for n, m in modes.items() if m[2] == BLS_PHASE]
    bls_modes.append("K1 mont_mul")

    # ---- phase 3: the main path, flagship.py at 2^20 ----------------------
    # its zkey (a 2^20 - 2 squaring chain, cached under build/zkeys), then
    # one 3-party Rep3 prove over run_parties on the warm card: every party
    # the same proof (prove_parties raises otherwise), verify_bn254 accepts,
    # every 8-word K1-K4 prover mode launched
    fz = flagship.build_zkey(FLAGSHIP_LOGN, dev)
    clear_counts()
    flag = flagship.prove_parties(fz["zkey"], fz["witness"], dev, proves=1)[0]
    launched = record(BN_PHASE)
    require_launched(BN_PHASE, prover_modes)
    if not flag["verified"]:
        raise AssertionError(f"{BN_PHASE}: proof does not verify")
    emit({"phase": BN_PHASE, "logn": FLAGSHIP_LOGN,
          "domain": fz["zkey"].domain_size, "zkey_seconds": fz["seconds"],
          "zkey_cache_hit": fz["cache_hit"],
          "zkey_peak_device_bytes": fz["peak_device_bytes"],
          "prove_s": flag["prove_wall_s"],
          "prove_s_by_party": flag["prove_s_by_party"], "verified": True,
          "parties_agree": True,
          "phase_seconds_by_party": flag["phase_seconds_by_party"],
          "peak_device_bytes": flag["peak_device_bytes"], **launched})
    del fz, flag
    torch.cuda.empty_cache()

    # the 2^16 zkey of phases 3b and 3c
    logn = 16
    t0 = time.perf_counter()
    zkey, w = setup.cached_synthetic_zkey((1 << logn) - 2)
    t_zkey = time.perf_counter() - t0
    n_inst = zkey.n_public + 1

    def run_prove(make_driver, zkey, w, verify=verify_bn254):
        n_inst = zkey.n_public + 1
        vk = prove.vk_from_zkey(zkey)

        def party(net):
            drv, share = make_driver(net)
            wit = prove.SharedWitness(public_inputs=w[:n_inst],
                                      witness=share)
            timings = {}
            proof = prove.prove(drv, zkey, wit, timings=timings)
            return proof, timings

        t0 = time.perf_counter()
        res = run_parties([party] * 3)
        torch.cuda.synchronize()
        proof = res[0][0]
        if not all(r[0] == proof for r in res):
            raise AssertionError("parties disagree")
        if not verify(vk, proof, w[1:n_inst]):
            raise AssertionError("proof does not verify")
        return res, time.perf_counter() - t0

    # ---- phase 3b: 3-party Shamir (n = 3, t = 1) on the 2^16 zkey ---------
    sh_shares = shamir.share_values(zkey.fr, w[n_inst:], 3, 1,
                                    random.Random(0x5A17), device=dev)

    def shamir_party(net):
        state = shamir.ShamirState.setup(net, zkey.fr, 1, pairs=32,
                                         seed=bytes([net.id + 0x51]) * 32)
        return drivers.ShamirDriver(net, state), sh_shares[net.id]

    clear_counts()
    res, t_shamir = run_prove(shamir_party, zkey, w)
    launched = record("shamir_groth16")
    require_launched("shamir_groth16", prover_modes)
    emit({"phase": "shamir_groth16", "domain": zkey.domain_size,
          "zkey_seconds": t_zkey, "n": 3, "t": 1, "prove_s": t_shamir,
          "verified": True,
          "phase_seconds_by_party": [r[1] for r in res], **launched})
    del sh_shares, res

    # ---- phase 3c: circom -> Rep3 witness extension -> .shared -> proof --
    # The co-circom CLI's generate-witness and generate-proof on the 2^16
    # zkey, through the port's entry points. Two barriers split the parties'
    # run into three counted stages: the VM (host ints) and
    # to_shared_witness_file (K1 on the card); writing and reading the
    # .shared bytes; the proof. A party waits at a barrier outside its turn.
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "chain.circom")
        with open(src, "w") as fh:
            fh.write(setup.chain_circom(zkey.n_vars - n_inst))
        prog = lang.load_program(src)
    inputs = shared.split_input_rep3(zkey.fr, {"x": w[1]},
                                     random.Random(0xC1C), device=dev)
    stages = []  # launch counts of a stage, when all parties arrive

    def stage():
        torch.cuda.synchronize()
        stages.append(read_counts())
        clear_counts()

    barrier = threading.Barrier(3, action=stage, timeout=900)

    def circom_party(net):
        i = net.id
        t0 = time.perf_counter()
        tree = mpc_run.shared_input_to_tree(json.loads(inputs[i]), zkey.fr, i)
        calls = count_calls(net, ("reshare_backward", "recv"))
        wit, n_wit_inst, drv = mpc_run.run_rep3_witness_extension(
            prog, zkey.fr, tree, net, seed=bytes([i + 0x31]) * 32)
        del net.reshare_backward, net.recv  # back to the class's methods
        t_vm = time.perf_counter()
        f = mpc_run.to_shared_witness_file(drv.pr, zkey.fr, wit, n_wit_inst,
                                           i, device=dev)
        torch.cuda.synchronize()
        t_file = time.perf_counter()
        with net.turn.blocked():
            barrier.wait()
        t_write = time.perf_counter()
        data = shared.write_shared_witness(f)
        f = shared.read_shared_witness(data, device=dev)
        torch.cuda.synchronize()
        t_read = time.perf_counter()
        with net.turn.blocked():
            barrier.wait()
        t_prove = time.perf_counter()
        state = rep3.Rep3State.setup(net, bytes([i + 0x41]) * 32)
        timings = {}
        proof = prove.prove(drivers.Rep3Driver(net, state), zkey,
                            prove.SharedWitness(f.public_inputs, rep3.Share(
                                f.share_a, f.share_b)), timings=timings)
        torch.cuda.synchronize()
        return {"proof": proof, "data": data, "rounds": calls,
                "vm_s": t_vm - t0, "to_shared_witness_file_s": t_file - t_vm,
                "write_read_s": t_read - t_write,
                "prove_s": time.perf_counter() - t_prove,
                "phase_seconds": timings}

    clear_counts()
    t0 = time.perf_counter()
    res = run_parties([circom_party] * 3)
    t_circom = time.perf_counter() - t0
    launched = record(CIRCOM_PHASE)
    witness_counts, file_counts = stages
    counts_by_phase[CIRCOM_PHASE + " witness"] = witness_counts
    proof = res[0]["proof"]
    if not all(r["proof"] == proof for r in res):
        raise AssertionError(f"{CIRCOM_PHASE}: parties disagree")
    files = [shared.read_shared_witness(r["data"], device=dev) for r in res]
    if any(f.public_inputs != w[:n_inst] for f in files):
        raise AssertionError(f"{CIRCOM_PHASE}: opened instance differs "
                             "from the zkey's")
    if rep3.combine_field_elements(zkey.fr, [rep3.Share(
            f.share_a, f.share_b) for f in files]) != w[n_inst:]:
        raise AssertionError(f"{CIRCOM_PHASE}: witness from the .shared "
                             "files differs from the zkey's")
    if not verify_bn254(prove.vk_from_zkey(zkey), proof, w[1:n_inst]):
        raise AssertionError(f"{CIRCOM_PHASE}: proof does not verify")
    require_launched(CIRCOM_PHASE + " witness", ["K1 mont_mul"])
    require_launched(CIRCOM_PHASE, prover_modes)
    vm_s = [r["vm_s"] for r in res]
    circom_prove_s = [r["prove_s"] for r in res]
    emit({"phase": CIRCOM_PHASE, "constraints": zkey.n_vars - n_inst,
          "witness_wires": zkey.n_vars, "wall_s": t_circom,
          "vm_s_by_party": vm_s, "vm_share_of_wall": max(vm_s) / t_circom,
          "to_shared_witness_file_s_by_party": [
              r["to_shared_witness_file_s"] for r in res],
          "write_read_s_by_party": [r["write_read_s"] for r in res],
          "prove_s_by_party": [r["prove_s"] for r in res],
          "rounds_by_party": [r["rounds"] for r in res],
          "verified": True, "parties_agree": True,
          "witness_matches_zkey": True,
          "witness_stage_launches": witness_counts,
          "file_stage_launches": file_counts,
          "phase_seconds_by_party": [r["phase_seconds"] for r in res],
          **launched})
    del res, files, inputs, prog
    torch.cuda.empty_cache()

    # ---- phase 3c': the same pipeline through the CLI, as users run it:
    # split-input, three generate-witness processes over TCP, three
    # generate-proof processes over TLS, verify; on a 2^15 zkey ----------
    t0 = time.perf_counter()
    zkey_cut, w_cut = setup.cached_synthetic_zkey((1 << CUT_LOGN) - 2)
    t_zkey_cut = time.perf_counter() - t0
    cli_line = cli_tcp_groth16(zkey_cut, w_cut, [
        (modes[n][0].__qualname__, key_str(modes[n][1]))
        for n in prover_modes])
    emit({"phase": "cli_tcp_groth16", "wall_s": time.perf_counter() - t0,
          "zkey_seconds": t_zkey_cut, **cli_line,
          "in_process_constraints": zkey.n_vars - n_inst,
          "in_process_vm_s_by_party": vm_s,
          "in_process_prove_s_by_party": circom_prove_s})
    del zkey, zkey_cut, w_cut

    # ---- phase 3d: 3-party Rep3 over BLS12-381 at domain 2^16 ------------
    t0 = time.perf_counter()
    bzkey, bw = setup.cached_synthetic_zkey((1 << logn) - 2,
                                            curve_pair=setup.BLS12_381)
    t_bzkey = time.perf_counter() - t0
    bn_inst = bzkey.n_public + 1
    b_shares = rep3.share_field_elements(bzkey.fr, bw[bn_inst:],
                                         random.Random(0xB15), device=dev)

    def bls_party(net):
        state = rep3.Rep3State.setup(net, bytes([net.id + 0x21]) * 32)
        return drivers.Rep3Driver(net, state), b_shares[net.id]

    clear_counts()
    res, t_prove = run_prove(bls_party, bzkey, bw, verify_bls12_381)
    launched = record(BLS_PHASE)
    require_launched(BLS_PHASE, bls_modes)
    emit({"phase": BLS_PHASE, "curve": "bls12_381",
          "domain": bzkey.domain_size, "zkey_seconds": t_bzkey,
          "prove_s": t_prove, "verified": True, "parties_agree": True,
          "phase_seconds_by_party": [r[1] for r in res], **launched})
    del bzkey, b_shares, res
    torch.cuda.empty_cache()

    # ---- phase 3e: 3-party Rep3 PLONK at domain 2^16, through the IO ----
    t0 = time.perf_counter()
    case = rep3_plonk_case(logn, dev)
    t_pzkey = time.perf_counter() - t0
    pzk = case.zk

    def run_plonk(make_party):
        """Prove on three parties; (per-party (proof, round seconds),
        wall seconds, peak device bytes). Fails unless every party returns
        the same proof and it verifies."""
        def party(net):
            drv, public, share = make_party(net)
            timings = {}
            proof = plonk_prove.prove(pzk, drv, public, share,
                                      timings=timings)
            return proof, timings

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_parties([party] * 3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        case.check([r[0] for r in res])
        return res, seconds, torch.cuda.max_memory_allocated()

    res, t_first, mem_first = run_plonk(case.party)
    clear_counts()
    res, t_warm, mem_warm = run_plonk(case.party)
    launched = record("rep3_plonk")
    require_launched("rep3_plonk", prover_modes)
    emit({"phase": "rep3_plonk", "domain": pzk.domain_size,
          "n_additions": pzk.n_additions, "zkey_seconds": t_pzkey,
          "zkey_bytes": len(case.zkey_bytes), "first_prove_s": t_first,
          "warm_prove_s": t_warm, "verified": True, "parties_agree": True,
          "peak_device_bytes": {"first": mem_first, "warm": mem_warm},
          "round_seconds_by_party": [r[1] for r in res], **launched})
    del res
    torch.cuda.empty_cache()

    # ---- phase 3f: 3-party Shamir (n = 3, t = 1) PLONK on the same zkey ----
    s_files = shared.split_witness_shamir(pzk.fr, case.wtns,
                                          pzk.n_public + 1, 3, 1,
                                          random.Random(0x5A18), device=dev)

    def plonk_shamir_party(net):
        f = shared.read_shared_witness(s_files[net.id], device=dev)
        state = shamir.ShamirState.setup(net, pzk.fr, 1, pairs=64,
                                         seed=bytes([net.id + 0x61]) * 32)
        return (plonk_drivers.ShamirPlonkDriver(pzk.fr, net, state),
                f.public_inputs, f.share_a)

    clear_counts()
    res, t_sh, mem_sh = run_plonk(plonk_shamir_party)
    launched = record("shamir_plonk")
    require_launched("shamir_plonk", prover_modes)
    del s_files
    torch.cuda.empty_cache()
    # round 3 burns 18 x 4n pairs in one degree reduction: one refill of
    # that size on its own, timed, with its peak device memory
    n_pairs = 18 * 4 * pzk.domain_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_parties([lambda net: shamir.ShamirState.setup(
        net, pzk.fr, 1, pairs=n_pairs, seed=bytes([net.id + 0x71]) * 32)
        for _ in range(3)])
    torch.cuda.synchronize()
    emit({"phase": "shamir_plonk", "domain": pzk.domain_size, "n": 3,
          "t": 1, "prove_s": t_sh, "verified": True, "parties_agree": True,
          "peak_device_bytes": mem_sh,
          "round_seconds_by_party": [r[1] for r in res],
          "refill_pairs": {"pairs": n_pairs,
                           "seconds": time.perf_counter() - t0,
                           "peak_device_bytes":
                               torch.cuda.max_memory_allocated()},
          **launched})
    del case, pzk, res
    torch.cuda.empty_cache()

    # ---- phase 3g: coNoir: Noir program -> Rep3 witness -> co-UltraHonk ---
    # A synthetic Noir artifact of 2^16 rows written to a file and read
    # back; its input shared; the 3-party co-ACVM and MPC UltraBuilder
    # (host Python, taking turns); each party's proving key (precomputed
    # polynomials public, witness shared) and vk on the card; co_prove
    # (Keccak) once, between two barriers that split off its launch counts.
    # The CRS is made on the card by local_crs (K2).
    # The plain pipeline proves the same witness in both flavors.
    fr_p = hpolyops.R
    program = synthetic.SMOKE_PROGRAM
    stage_s = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.json")
        nacir.dump_artifact(path, *synthetic.synthetic_program(**program))
        artifact_bytes = os.path.getsize(path)
        art = nacir.load_artifact(path)
    af = hbuilder.AcirFormat.from_function(art.functions[0])
    n_wit = af.max_witness_index + 1
    noir_inputs = synthetic.synthetic_inputs(program["n_inputs"], 0x401)
    share_rand = random.Random(0x402).randbytes
    in_shares = [Rep3Scalar.share(v, fr_p, rand=share_rand)
                 for v in noir_inputs]
    stage_s["artifact"] = time.perf_counter() - t0

    clear_counts()
    t0 = time.perf_counter()
    hcrs_dev = hcrs.local_crs(1 << 16, device=dev)
    torch.cuda.synchronize()
    stage_s["crs"] = time.perf_counter() - t0
    crs_launches = {k: sum(v.values()) for k, v in read_counts().items()}
    if not crs_launches[ek.jacobian_launch.__qualname__]:
        raise AssertionError(f"local_crs launched no K2: {crs_launches}")

    keccak = htranscript.HASHERS["keccak"]
    noir_stages = {}
    spied = {}
    spy_on = [False]
    commit_open = Rep3HonkDriver.commit_open

    def spy(self, coeffs, crs):
        out = commit_open(self, coeffs, crs)
        k = coeffs.a.shape[0]
        if spy_on[0] and 256 <= k <= 1024 and self.id not in spied:
            spied[self.id] = (coeffs.a.cpu(), out)
        return out

    def noir_stage(name):
        def action():
            torch.cuda.synchronize()
            noir_stages[name] = (time.perf_counter(), read_counts())
            if name == "start":
                clear_counts()
                torch.cuda.reset_peak_memory_stats()
                spy_on[0] = True
            if name == "proved":
                noir_stages["peak"] = torch.cuda.max_memory_allocated()
                spy_on[0] = False
        return action

    bar_start = threading.Barrier(3, action=noir_stage("start"), timeout=900)
    bar_proved = threading.Barrier(3, action=noir_stage("proved"),
                                   timeout=900)

    def noir_party(net):
        i = net.id
        keys = [bytes([0x81 + j]) * 32 for j in range(3)]
        vm = Rep3Driver(Rep3Scalar(net, HostRng(keys[i], keys[(i + 1) % 3]),
                                   fr_p), hpolyops.FR)
        calls = count_calls(net, ("reshare_backward", "broadcast"))
        out = {}
        t = time.perf_counter()
        wmap = nsolver.solve_program(art, vm, fr_p,
                                     [sh[i] for sh in in_shares])
        wit = [vm.norm(wmap.get(j, 0)) for j in range(n_wit)]
        out["acvm_s"] = time.perf_counter() - t
        out["acvm_rounds"] = dict(calls)
        opened = vm.pr.open_many([vm.to_share(v) for v in wit])
        t = time.perf_counter()
        b = hbuilder.UltraBuilder.create_circuit(af, wit, driver=vm)
        out["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        pk = hpk.create_proving_key(b)
        out["proving_key_s"] = time.perf_counter() - t
        out["mpc_rounds"] = {k: calls[k] - out["acvm_rounds"][k]
                             for k in calls}
        del net.reshare_backward, net.broadcast
        t = time.perf_counter()
        pk = pk.to_device(dev, hpk.PRECOMPUTED)
        vk = hpk.create_vk(pk, hcrs_dev)
        out["vk_s"] = time.perf_counter() - t
        drv = Rep3HonkDriver(net, rep3.Rep3State.setup(
            net, bytes([i + 0x91]) * 32))
        t = time.perf_counter()
        pk_pub, shared = hco.split_builder_pk(pk, drv)
        shared = hco.shared_witness_to_device(shared, dev)
        torch.cuda.synchronize()
        out["to_device_s"] = time.perf_counter() - t
        with net.turn.blocked():
            bar_start.wait()
        tim = {}
        t = time.perf_counter()
        proof = hco.co_prove(pk_pub, shared, vk, hcrs_dev, keccak, drv,
                             timings=tim)
        tim["total"] = time.perf_counter() - t
        with net.turn.blocked():
            bar_proved.wait()
        out["prove_rounds"] = drv.rounds
        out["prove_s"] = tim
        return out, opened, vk, proof, pk_pub.circuit_size

    Rep3HonkDriver.commit_open = spy
    try:
        clear_counts()
        t0 = time.perf_counter()
        nres = run_parties([noir_party] * 3)
    finally:
        Rep3HonkDriver.commit_open = commit_open
    noir_wall = time.perf_counter() - t0
    launched = record(NOIR_PHASE)
    t_proof = noir_stages["proved"][0] - noir_stages["start"][0]
    require_launched(NOIR_PHASE, ["K1 mont_mul", "K3 proj add",
                                  "K4 fold level 0"])
    co_proof = nres[0][3]
    if not all(r[3] == co_proof for r in nres):
        raise AssertionError("coNoir: parties' proofs differ")
    if nres[0][4] != 1 << 16:
        raise AssertionError(f"coNoir: circuit size {nres[0][4]}")

    # the plain pipeline on the same witness, both flavors on the card
    t0 = time.perf_counter()
    pw = nsolver.solve_program(art, PlainDriver(hpolyops.FR), fr_p,
                               noir_inputs)
    plain_wit = [int(pw.get(j, 0)) for j in range(n_wit)]
    if [int(v) for v in nres[0][1]] != plain_wit:
        raise AssertionError("coNoir: opened witness != plain witness")
    plain_pk = hpk.create_proving_key(
        hbuilder.UltraBuilder.create_circuit(af, plain_wit)).to_device(dev)
    plain_vk = hpk.create_vk(plain_pk, hcrs_dev)
    t_plain_key = time.perf_counter() - t0
    if plain_vk.commitments != nres[0][2].commitments:
        raise AssertionError("coNoir: MPC vk != plain vk")
    plain_s, plain_timings, verify_s = {}, {}, {}
    for flavor in ("keccak", "poseidon2"):
        hasher = htranscript.HASHERS[flavor]
        plain_timings[flavor] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = hprover.prove(plain_pk, plain_vk, hcrs_dev, hasher,
                              timings=plain_timings[flavor])
        torch.cuda.synchronize()
        plain_s[flavor] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not hverifier.verify(proof[0], proof[1], plain_vk,
                                hcrs_dev.g2_x, hasher):
            raise AssertionError(f"coNoir: plain {flavor} proof refused")
        verify_s[flavor] = time.perf_counter() - t0
        if flavor == "keccak":
            if proof != co_proof:
                raise AssertionError("coNoir: co-proof != plain proof")
            bad = list(proof[0])
            bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % fr_p
            if hverifier.verify(bad, proof[1], plain_vk, hcrs_dev.g2_x,
                                hasher):
                raise AssertionError("coNoir: a changed proof verified")
    # one commitment of the co-proof against the host Pippenger on the
    # opened coefficients (outside the phase's timings)
    t0 = time.perf_counter()
    coeffs = [sum(v) % fr_p for v in zip(*[
        hpolyops.decode(spied[j][0]) for j in range(3)])]
    idx = [j for j, c in enumerate(coeffs) if c]
    host_pt = hpolyops._host_pippenger(
        [hcrs_dev.monomials[j] for j in idx], [coeffs[j] for j in idx])
    if not (host_pt == spied[0][1] == spied[1][1] == spied[2][1]):
        raise AssertionError("coNoir: commitment != host Pippenger")
    t_commit_check = time.perf_counter() - t0
    emit({"phase": NOIR_PHASE, "rows": nres[0][4],
          "program": program, "artifact_bytes": artifact_bytes,
          "opcodes": len(art.functions[0].opcodes),
          "stage_seconds": {**stage_s,
                            "acvm_by_party": [r[0]["acvm_s"] for r in nres],
                            "build_by_party": [r[0]["build_s"]
                                               for r in nres],
                            "proving_key_by_party": [r[0]["proving_key_s"]
                                                     for r in nres],
                            "vk_by_party": [r[0]["vk_s"] for r in nres],
                            "to_device_by_party": [r[0]["to_device_s"]
                                                   for r in nres]},
          "co_prove_seconds_by_party": [r[0]["prove_s"] for r in nres],
          "co_prove_s": t_proof, "wall_s": noir_wall,
          "plain_key_s": t_plain_key, "plain_prove_s": plain_s,
          "plain_prove_parts": plain_timings, "verify_s": verify_s,
          "rounds_by_party": [{"acvm": r[0]["acvm_rounds"],
                               "mpc_build": r[0]["mpc_rounds"],
                               "co_prove": r[0]["prove_rounds"]}
                              for r in nres],
          "crs_launches": crs_launches,
          "setup_launches": {
              k: sum(v.values())
              for k, v in noir_stages["start"][1].items()},
          "peak_device_bytes": noir_stages["peak"],
          "proof_words": len(co_proof[0]), "public_inputs": co_proof[1],
          "parties_agree": True, "equals_plain_keccak": True,
          "witness_matches_plain": True, "verified": True,
          "changed_word_refused": True,
          "commitment_check": {"coefficients": len(coeffs),
                               "equals_host_pippenger": True,
                               "seconds": t_commit_check},
          **launched})
    noir_prove_s = [r[0]["prove_s"] for r in nres]
    del nres, plain_pk, hcrs_dev, art, af
    torch.cuda.empty_cache()

    # ---- phase 3h: the same program through the coNoir CLI, as users run
    # it: prove, split-proving-key, three REP3 generate-proof processes
    # over TLS, three SHAMIR ones over TCP, verify --------------------------
    t0 = time.perf_counter()
    noir_required = [
        (fn.__qualname__, key)
        for fn in (mont_kernel.mul, ek.jacobian_launch, ek.proj_launch,
                   ek.fold_launch)
        for key, n in counts_by_phase[NOIR_PHASE][fn.__qualname__].items()
        if n and key.startswith("8w:") and not key.endswith(WG.g1.name)]
    cli_noir = cli_tcp_noir(program, pw, co_proof, noir_required)
    emit({"phase": "cli_tcp_noir", "rows": 1 << 16,
          "wall_s": time.perf_counter() - t0, **cli_noir,
          "required_launches": [f"{a} {b}" for a, b in noir_required],
          "in_process_co_prove_s_by_party": [r_s["total"]
                                             for r_s in noir_prove_s]})
    del pw

    # ---- phase 3i: one party's local step and the multi-device dry run ----
    clear_counts()
    md_line = multidevice_phase(dev)
    launched = record("multidevice")
    require_launched("multidevice", ["K1 mont_mul", "K2 jacobian add",
                                     "K2 jacobian double", "K3 proj add",
                                     "K4 fold level 0"])
    emit({"phase": "multidevice", **md_line, **launched})

    # ---- phase 4: bench.py's shape: 2^20-point G1 MSM at c = 15 ----------
    nm = 1 << 20

    def ints(limbs):
        raw = limbs.astype("<u2").tobytes()
        return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
                for i in range(limbs.shape[0])]

    def msm_inputs(g1, seed, s_top):
        """2^20 affine points [k_i]G of g1 made on the card (64-bit k_i),
        scalar limbs s_i (top limb below s_top, so s_i < r), the host's
        [sum s_i k_i]G, and the seconds the points took."""
        nrng = np.random.default_rng(seed)
        k_limbs = np.zeros((nm, 16), dtype=np.uint16)
        k_limbs[:, :4] = nrng.integers(0, 1 << 16, (nm, 4))  # 64-bit k_i
        s_limbs = nrng.integers(0, 1 << 16, (nm, 16)).astype(np.uint16)
        s_limbs[:, 15] &= s_top - 1
        ks, ss = ints(k_limbs), ints(s_limbs)
        t0 = time.perf_counter()
        kt = torch.as_tensor(k_limbs.astype(np.int64), device=dev)
        st = torch.as_tensor(s_limbs.astype(np.int64), device=dev)
        G = tuple(x[0].expand((nm, x.shape[-1])) for x in ec.encode_points(
            g1, [g1.generator], device=dev))
        pts = ec.to_affine(g1, ec.scalar_mul(g1, G, kt))
        torch.cuda.synchronize()
        t_points = time.perf_counter() - t0
        hc = host.host_curve(g1)
        r = g1.scalar_field.p
        expect = hc.affine_ints(hc.mul(
            hc.generator, sum(s * k for s, k in zip(ss, ks)) % r))
        return pts, st, expect, t_points

    def wall(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def splits(g1, pts, st, c):
        """msm() and the other split, _host_horner(_pippenger_wsums)."""
        return (lambda: msm.msm(g1, pts, st, c=c),
                lambda: msm._host_horner(
                    g1, msm._pippenger_wsums(g1, pts, st, c), c))

    def wsums_pairs(g1, pts, st, c, expect, phase, required, pairs):
        """One counted run of the wsums split (K4, K6 on the card, Horner on
        the host), checked against the host, then `pairs` pairs of it and
        msm() taking turns at going first (host speed moves both by tens of
        percent between calls)."""
        run_msm, run_wsums = splits(g1, pts, st, c)
        clear_counts()
        wout, _ = wall(run_wsums)
        counts_by_phase[phase] = by_op = read_counts()
        require_launched(phase, required)
        if ec.decode_points(g1, tuple(x[None] for x in wout))[0] != expect:
            raise AssertionError(f"{phase}: wsums + host Horner differs "
                                 "from the host")
        wtimes, mtimes = [], []
        for i in range(pairs):
            for fn in ((run_wsums, run_msm) if i % 2
                       else (run_msm, run_wsums)):
                (wtimes if fn is run_wsums else mtimes).append(wall(fn)[1])
        return {"c": c, "wsums_horner_s": wtimes, "msm_s": mtimes,
                "pairs_won_by_wsums": sum(w < m for w, m in zip(wtimes,
                                                                mtimes)),
                "points_per_s": nm / min(wtimes), "matches_host": True,
                "launches_by_mode": by_op}

    pts, st, expect, t_points = msm_inputs(g1, 0xBE7C, 1 << 13)  # < 2^253
    run_msm, _ = splits(g1, pts, st, 15)
    wall(run_msm)  # warm
    times = []
    for _ in range(3):
        out, t = wall(run_msm)
        times.append(t)
    got = ec.decode_points(g1, tuple(x[None] for x in out))[0]
    if got != expect:
        raise AssertionError("2^20 MSM differs from the host")
    emit({"phase": "msm_2^20", "c": 15, "points_setup_s": t_points,
          "msm_s": times, "points_per_s": nm / min(times),
          "matches_host": True})

    # ---- phase 4b: the same MSM, window sums on the card (K4, K6), Horner
    # on the host; one counted call, then ten pairs against msm() in turns
    emit({"phase": "msm_wsums_2^20", **wsums_pairs(
        g1, pts, st, 15, expect, "msm_wsums_2^20",
        ["K4 fold level 0", "K6 wreduce 2^20/c=15"], 10)})
    del pts, st, out
    torch.cuda.empty_cache()

    # ---- phase 4c: both splits on 2^20 BLS12-381 G1 points at c = 16 (K4
    # and K6 at 12 words): msm() checked, then the wsums split counted,
    # checked and in three pairs taking turns. c = 15 is refused for a
    # 255-bit scalar field (msm.signed_digits: the top signed digit could
    # overflow), in the JAX package as here ----------------------------
    bls = W12.g1
    pts, st, expect, t_points = msm_inputs(bls, 0xB1512, 1 << 14)  # < r
    run_msm, _ = splits(bls, pts, st, 16)
    out, t_msm = wall(run_msm)
    if ec.decode_points(bls, tuple(x[None] for x in out))[0] != expect:
        raise AssertionError("2^20 BLS12-381 MSM differs from the host")
    emit({"phase": "msm_wsums_2^20 w12", "curve": "bls12_381",
          "points_setup_s": t_points, "first_msm_s": t_msm,
          "msm_matches_host": True, **wsums_pairs(
              bls, pts, st, 16, expect, "msm_wsums_2^20 w12",
              ["K4 fold level 0 w12", "K6 wreduce 2^20/c=16 w12"], 3)})
    del pts, st, out
    torch.cuda.empty_cache()

    # ---- phase 5: the proofs' loss, launch size by launch size -----------
    # Each K1-K3 prover mode, at each width, is timed at every size bucket
    # at which one of the seven proofs (Groth16: the Rep3, the Shamir,
    # the co-circom and the BLS12-381 one; PLONK: the warm Rep3 and the
    # Shamir one; UltraHonk: the warm coNoir co-proof) launched it
    # (random canonical operands, ordinary points), and each K4 mode at
    # every exact (L, K) they launched (random operands, phase 2's flags),
    # held against its plain version, and its loss per proof summed as
    # launches x (ms - bound_ms), a bucket at or below its bound adding 0
    def k1_plain(F_, x, y, chunk=1 << 20):
        """K1's plain version in chunks of 2^20 products (its temporaries
        take 10 KB a product)."""
        return torch.cat([mont.mul_plain(F_, x[i:i + chunk], y[i:i + chunk])
                          for i in range(0, x.shape[0], chunk)])

    def case(w, launch, plain, ncoords, nout, field_muls):
        def make(n):
            c = [w.rand_fe(n) for _ in range(ncoords)]
            return (lambda: launch(c), lambda: plain(c),
                    (ncoords + nout) * n * w.limb_bytes,
                    field_muls * n * w.muls)
        return make

    cases = {}
    for w in (W8, W12):
        F_, g_ = w.F, w.g1
        cases.update({
            "K1 mont_mul" + w.tag: case(
                w, lambda c, F_=F_: (mont_kernel.mul(F_, *c),),
                lambda c, F_=F_: (k1_plain(F_, *c),), 2, 1, 1),
            "K2 jacobian add" + w.tag: case(
                w, lambda c, g_=g_: ek.jacobian_launch(g_, ek.JAC_ADD, c),
                lambda c, g_=g_: ek.add_plain(g_, tuple(c[:3]),
                                              tuple(c[3:])), 6, 3, 16),
            "K2 jacobian double" + w.tag: case(
                w, lambda c, g_=g_: ek.jacobian_launch(g_, ek.JAC_DOUBLE,
                                                       c),
                lambda c, g_=g_: ek.double_plain(g_, tuple(c)), 3, 3, 7),
            "K3 proj add" + w.tag: case(
                w, lambda c, g_=g_: ek.proj_launch(g_, ek.PROJ_ADD, c),
                lambda c, g_=g_: ek.proj_add_plain(g_, tuple(c[:3]),
                                                   tuple(c[3:])), 6, 3, 12),
            "K3 proj double" + w.tag: case(
                w, lambda c, g_=g_: ek.proj_launch(g_, ek.PROJ_DOUBLE, c),
                lambda c, g_=g_: ek.proj_double_plain(g_, tuple(c)),
                3, 3, 8),
        })
    buckets, loss = [], {ph: dict.fromkeys(cases, 0.0) for ph in PROOFS}
    for name, make in cases.items():
        for n in sorted({int(bk) for ph in PROOFS
                         for bk in sizes_by_phase[ph][name]}):
            kernel_fn, plain_fn, nbytes, nmuls = make(n)
            out, ms, enqueue_ms = timed(kernel_fn, 200 if n <= 1 << 15
                                        else 20, queue_ahead=True)
            if max_err(out, plain_fn()) != 0:
                raise AssertionError(f"{name} at {n}: kernel differs from "
                                     "plain version")
            bms, by = bound(nbytes, nmuls)
            launches = {ph: sizes_by_phase[ph][name].get(str(n), 0)
                        for ph in PROOFS}
            buckets.append({"mode": name, "bucket": n, "ms": ms,
                            "bound_ms": bms, "bound_by": by,
                            "max_abs_err": 0, "enqueue_ms": enqueue_ms,
                            "launches": launches})
            for ph in PROOFS:
                loss[ph][name] += launches[ph] * max(0.0, ms - bms)
            del kernel_fn, plain_fn, out
    widths = {8: W8, 12: W12}
    fold_modes = {(w.words, m, w.g1.name): name + w.tag for w in (W8, W12)
                  for m, name in ((0, "K4 fold level 0"),
                                  (1, "K4 fold projective"))}
    for ph in PROOFS:
        loss[ph].update(dict.fromkeys(fold_modes.values(), 0.0))
    for m, L, k in sorted({key for ph in PROOFS
                           for key in shapes_by_phase[ph]}):
        name = fold_modes[m]
        kernel_fn, plain_fn, nbytes, nmuls = fold_case(
            widths[m[0]], L, bool(m[1]), K=k)
        out, ms, enqueue_ms = timed(kernel_fn, 5 if L > 4096 else 20,
                                    queue_ahead=True)
        if max_err(out, plain_fn()) != 0:
            raise AssertionError(f"{name} at L = {L}: kernel differs from "
                                 "plain version")
        bms, by = bound(nbytes, nmuls)
        launches = {ph: shapes_by_phase[ph].get((m, L, k), 0)
                    for ph in PROOFS}
        buckets.append({"mode": name, "L": L, "K": k, "ms": ms,
                        "bound_ms": bms, "bound_by": by, "max_abs_err": 0,
                        "enqueue_ms": enqueue_ms, "launches": launches})
        for ph in PROOFS:
            loss[ph][name] += launches[ph] * max(0.0, ms - bms)
        del kernel_fn, plain_fn, out
    emit({"phase": "main_path_loss", "buckets": buckets, "loss_ms": loss})

    # ---- phase 6: kernel table, card, result -----------------------------
    # a row's launches come from the phase that runs its mode (the BN254
    # Rep3 proof for the 8-word prover modes, the BLS12-381 one for the
    # 12-word ones); a mode that no proof runs reads that width's proof.
    # The point kernels count per curve, so Grumpkin's rows read
    # Grumpkin's launches
    for row in rows.values():
        fn, mode, phase = modes[row["mode"]]
        counted_in = phase or (BN_PHASE if mode[0] == 8 else BLS_PHASE)
        row["launches"] = counts_by_phase[counted_in][fn.__qualname__].get(
            key_str(mode), 0)
        row["launches_by_proof"] = {
            ph: counts_by_phase[ph][fn.__qualname__].get(key_str(mode), 0)
            for ph in PROOFS}
        row["reached_by"] = phase or "kernel_check"
        if row["mode"].endswith(GRUMPKIN_TAG):
            row["curve"] = "grumpkin"
        row["words"] = mode[0]
        if row["mode"] in cases:
            row["launches_at_shape"] = sizes_by_phase[counted_in][
                row["mode"]].get(str(mont_kernel.size_bucket(
                    row["shape"][0])), 0)
            row["main_path_loss_ms"] = loss[counted_in][row["mode"]]
            row["main_path_loss_ms_by_proof"] = {
                ph: loss[ph][row["mode"]] for ph in PROOFS}
        elif row["mode"] in fold_modes.values():
            k, L = row["shape"]
            row["launches_at_shape"] = shapes_by_phase[counted_in].get(
                (mode, L, k), 0) if row["flags"] == "smoke" else 0
            row["main_path_loss_ms"] = loss[counted_in][row["mode"]]
            row["main_path_loss_ms_by_proof"] = {
                ph: loss[ph][row["mode"]] for ph in PROOFS}
        else:
            row["main_path_loss_ms"] = row["launches"] * max(
                0.0, row["ms"] - row["bound_ms"])
    emit({"kernels": list(rows.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
