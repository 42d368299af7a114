"""A whole 3-party Rep3 Groth16 proof over BN254, as co-circom's parties
make it: `groth16/prove.py` `prove` with `drivers.Rep3Driver` a party, the
parties threads over the program's LocalNetwork taking turns on one card.

Set-up draws from the seed the key's toxic waste (the program's
`synthetic_zkey` of the squaring chain, on the card), x_0 of the chain, the
Rep3 shares of the witness, and each proof's PRF seeds.

The check, after the window, with the reference alone: every party returned
the same proof; the proof verifies under the verifying key that the
reference works out from the seed's toxic waste, for the public x_0; no two
proofs of the run are the same (each proof draws fresh randomness); and the
key's verifying-key points and a sample of its query points drawn from the
seed equal the reference's.
"""

from __future__ import annotations

import random

from cosnarks_tpu_torch.groth16 import drivers, setup
from cosnarks_tpu_torch.groth16 import prove as g16
from cosnarks_tpu_torch.mpc import rep3

from ..reference import groth16 as ref
from ..reference.bn254 import (R, decode_g1_affine_mont,
                               decode_g2_affine_mont)
from . import common

KEY_SAMPLES = 4  # query points of each kind compared with the reference


class Job:
    noun = "proof"
    items_per_job = 1

    def __init__(self, config, mix, seed, device, wanted, counters):
        self.seed = seed
        self.device = device
        self.wanted = wanted
        self.counters = counters
        self.ncon = (1 << config["domain_pow"]) - 2  # domain 2^domain_pow
        self.key_seed = common.seed_bytes(seed, b"groth16-key")

    def setup(self):
        self.zkey, _ = setup.synthetic_zkey(
            self.ncon, seed=self.key_seed, device=self.device)
        self.x0 = common.draw(self.seed, b"x0", R)
        w = ref.chain_witness(self.x0, self.ncon)
        self.n_inst = self.zkey.n_public + 1
        self.public = w[:self.n_inst]
        self.shares = rep3.share_field_elements(
            self.zkey.fr, w[self.n_inst:],
            random.Random(common.seed_bytes(self.seed, b"shares")),
            device=self.device)

    def run_one(self, k):
        def prove_party(net, state, timings):
            wit = g16.SharedWitness(public_inputs=self.public,
                                    witness=self.shares[net.id])
            return g16.prove(drivers.Rep3Driver(net, state), self.zkey, wit,
                             timings=timings)

        return common.rep3_round(self.seed, k, self.device, prove_party,
                                 self.counters, self.wanted)

    def release(self):
        self.shares = None

    def check(self, outputs, warm):
        vk = ref.ChainKey(self.key_seed, self.ncon).vk()
        ok = common.check_proofs(
            outputs, warm, lambda p: ref.verify(vk, p, self.public[1:]))
        return ok, [("failed_proofs", ok.count(False), 0),
                    ("key_mismatches", self._key_mismatches(vk), 0)]

    def _key_mismatches(self, vk) -> int:
        z = self.zkey
        bad = 0
        for name in ("alpha_g1", "beta_g1", "delta_g1"):
            bad += decode_g1_affine_mont(getattr(z, name)) != vk[name]
        for name in ("beta_g2", "gamma_g2", "delta_g2"):
            bad += decode_g2_affine_mont(getattr(z, name)) != vk[name]
        bad += len(z.ic) != len(vk["ic"])
        bad += sum(decode_g1_affine_mont(a) != b
                   for a, b in zip(z.ic, vk["ic"]))
        key = ref.ChainKey(self.key_seed, self.ncon)
        rng = random.Random(common.seed_bytes(self.seed, b"key-samples"))
        for name, arr, g2 in (("a_query", z.a_query, False),
                              ("b_g1_query", z.b_g1_query, False),
                              ("b_g2_query", z.b_g2_query, True),
                              ("c_query", z.c_query, False),
                              ("h_query", z.h_query, False)):
            decode = decode_g2_affine_mont if g2 else decode_g1_affine_mont
            for i in rng.sample(range(len(arr)), min(KEY_SAMPLES, len(arr))):
                bad += decode(arr[i]) != getattr(key, name)(i)
        return int(bad)
