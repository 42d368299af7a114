"""A whole 3-party Rep3 co-UltraHonk proof over BN254, Keccak flavour:
`honk/co_prover.py` `co_prove` with `co_driver.Rep3HonkDriver` a party, the
parties threads over the program's LocalNetwork taking turns on one card.

Set-up, from the seed: the CRS's tau and `local_crs` on the card; then for
each of the mix's input sets, its 32-bit private inputs, the plain ACVM
solve of the configuration's synthetic Noir program
(`noir/synthetic.synthetic_program`), the plain `UltraBuilder`, the proving
key on the card, its verifying key (`create_vk`), and the witness
polynomials split into Rep3 shares on the card (`share_proving_key`,
co-noir's split-proving-key flow). Job k proves input set k % input_sets,
with fresh PRF seeds.

The check, after the window, with the reference alone
(`portbench/reference/ultrahonk.py`): a proof fails if the parties'
proofs differ, the reference refuses it under its input set's public
input and the verifying key that the reference works out itself (the key's
coefficients read back from the card, tau from the seed), another proof of
its input set differs from it (the flavour is deterministic), or a proof of
the other input set equals it. The key's commitments, [tau]G2 and a seeded
sample of the CRS's powers are compared with the reference's.
"""

from __future__ import annotations

import os
import random
import tempfile
from collections import defaultdict

import numpy as np

from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.honk import builder, co_prover, crs as honk_crs
from cosnarks_tpu_torch.honk import proving_key as hpk
from cosnarks_tpu_torch.honk.co_driver import Rep3HonkDriver
from cosnarks_tpu_torch.honk.transcript import HASHERS
from cosnarks_tpu_torch.noir import acir, solver, synthetic
from cosnarks_tpu_torch.vm.interp import PlainDriver

from ..reference import ultrahonk as ref
from ..reference.bn254 import MONT_R, R, limbs_to_ints
from . import common

KEY_SAMPLES = 8  # powers of tau compared with the reference
KECCAK = HASHERS["keccak"]


class InputSet:
    """One witness of the program: its proving key (polynomials on the
    card), verifying key, each party's shared witness polynomials on the
    card, and its public inputs (the program's return value)."""

    def __init__(self, pk, vk, witness: list, public: list):
        self.pk = pk
        self.vk = vk
        self.witness = witness
        self.public = public
        self.coeffs = None  # precomputed polynomials' limbs, on the host


class Job:
    noun = "proof"
    items_per_job = 1

    def __init__(self, config, mix, seed, device, wanted, counters):
        self.seed = seed
        self.device = device
        self.wanted = wanted
        self.counters = counters
        self.program = config["program"]
        self.rows = 1 << config["log_rows"]
        self.n_sets = mix["input_sets"]
        self.tau = common.draw(seed, b"ultrahonk-tau", R)

    def setup(self):
        cuda = self.device.type == "cuda"
        self.crs = honk_crs.local_crs(self.rows, tau=self.tau,
                                      device=self.device if cuda else None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "program.json")
            acir.dump_artifact(path, *synthetic.synthetic_program(
                **self.program))
            art = acir.load_artifact(path)
        af = builder.AcirFormat.from_function(art.functions[0])
        self.sets = [self._input_set(art, af, s)
                     for s in range(self.n_sets)]

    def _input_set(self, art, af, s: int) -> InputSet:
        rng = random.Random(common.seed_bytes(self.seed, b"inputs:%d" % s))
        inputs = [rng.getrandbits(32)
                  for _ in range(self.program["n_inputs"])]
        wmap = solver.solve_program(art, PlainDriver(BN254_FR), R, inputs)
        wit = [int(wmap.get(i, 0)) for i in range(af.max_witness_index + 1)]
        pk = hpk.create_proving_key(builder.UltraBuilder.create_circuit(
            af, wit))
        if pk.circuit_size != self.rows:
            raise ValueError(f"the program has {pk.circuit_size} rows, the "
                             f"configuration says {self.rows}")
        pkd = pk.to_device(self.device)
        shares = co_prover.share_proving_key(pk, random.Random(
            common.seed_bytes(self.seed, b"shares:%d" % s)))
        witness = [co_prover.shared_witness_to_device(sh, self.device)
                   for sh in shares]
        public = pk.public_inputs[:pk.num_public_inputs
                                  - ref.PAIRING_POINT_ACCUMULATOR_SIZE]
        return InputSet(pkd, hpk.create_vk(pkd, self.crs), witness,
                        [int(v) for v in public])

    def run_one(self, k):
        s = self.sets[k % self.n_sets]

        def prove_party(net, state, timings):
            drv = Rep3HonkDriver(net, state)
            return co_prover.co_prove(s.pk, s.witness[net.id], s.vk,
                                      self.crs, KECCAK, drv, timings=timings)

        return common.rep3_round(self.seed, k, self.device, prove_party,
                                 self.counters, self.wanted)

    def release(self):
        """Keep what the check reads of the key (its precomputed
        polynomials, as 16-bit limbs on the host) and free the card."""
        for s in self.sets:
            s.coeffs = [s.pk.polynomials[name].cpu().numpy().astype(np.uint16)
                        for name in ref.PRECOMPUTED]
            s.pk = s.witness = None

    def check(self, outputs, warm):
        inv = pow(MONT_R, -1, R)
        tau_g2 = ref.g2_x(self.tau)
        bad_keys = self._crs_mismatches(tau_g2)
        ref_vks = []
        for s in self.sets:
            comms = [ref.commitment([x * inv % R for x in limbs_to_ints(c)],
                                    self.tau) for c in s.coeffs]
            bad_keys += sum(a != b for a, b in zip(s.vk.commitments, comms))
            ref_vks.append(ref.VerifyingKey(
                s.vk.log_circuit_size, s.vk.num_public_inputs,
                s.vk.pub_inputs_offset, comms))
            s.coeffs = None

        def sig(parties):
            proof, public = parties[0]
            return tuple(proof), tuple(public)

        jobs = [((-1 - i) % self.n_sets, o) for i, o in enumerate(warm)]
        window = [(k % self.n_sets, o) for k, o in enumerate(outputs)]
        seen = defaultdict(set)
        for s, parties in jobs + window:
            seen[s].add(sig(parties))
        verdicts = {}

        def verifies(s, parties):
            key = (s, sig(parties))
            if key not in verdicts:
                verdicts[key] = ref.verify(ref_vks[s], parties[0][0],
                                           self.sets[s].public, tau_g2)
            return verdicts[key]

        ok = []
        for s, parties in window:
            others = set().union(*(seen[t] for t in seen if t != s))
            ok.append(all(p == parties[0] for p in parties)
                      and len(seen[s]) == 1 and sig(parties) not in others
                      and verifies(s, parties))
        return ok, [("failed_proofs", ok.count(False), 0),
                    ("key_mismatches", int(bad_keys), 0)]

    def _crs_mismatches(self, tau_g2) -> int:
        bad = int(self.crs.g2_x != tau_g2)
        rng = random.Random(common.seed_bytes(self.seed, b"key-samples"))
        n = len(self.crs.monomials)
        for i in rng.sample(range(n), min(KEY_SAMPLES, n)):
            bad += self.crs.monomials[i] != ref.crs_point(i, self.tau)
        return bad
