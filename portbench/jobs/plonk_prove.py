"""A whole 3-party Rep3 snarkjs-PLONK proof over BN254: `plonk/prove.py`
`prove` with `drivers.Rep3PlonkDriver` a party, the parties threads over the
program's LocalNetwork taking turns on one card.

Set-up draws from the seed the key's tau, x_0 of the chain and the
additions' coefficients (`portbench/plonk_fixture.py`, on the card), the Rep3
shares of the witness, and each proof's PRF seeds.

The check, after the window, with the reference alone: every party returned
the same proof; the proof verifies under the verifying key that the
reference works out from the seed's tau and the circuit; no two proofs of
the run are the same; and the key's commitments, X_2 and a sample of its
powers of tau equal the reference's.
"""

from __future__ import annotations

import random

from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.plonk import drivers
from cosnarks_tpu_torch.plonk import prove as plonk

from .. import plonk_fixture
from ..reference import plonk as ref
from ..reference.bn254 import (G1, decode_g1_affine_mont,
                               decode_g2_affine_mont)
from . import common

KEY_SAMPLES = 8  # powers of tau compared with the reference
ZKEY_FIELDS = dict(zip(ref.COMMITMENTS, ("qm_c", "ql_c", "qr_c", "qo_c",
                                         "qc_c", "s1_c", "s2_c", "s3_c")))


class Job:
    noun = "proof"
    items_per_job = 1

    def __init__(self, config, mix, seed, device, wanted, counters):
        self.seed = seed
        self.device = device
        self.wanted = wanted
        self.counters = counters
        self.domain_pow = config["domain_pow"]
        self.n_additions = config["n_additions"]
        self.key_seed = common.seed_bytes(seed, b"plonk-key")

    def setup(self):
        self.zk, wtns = plonk_fixture.build_zkey(
            self.domain_pow, self.n_additions, self.key_seed, self.device)
        ni = self.zk.n_public + 1
        self.public = wtns[:ni]
        self.shares = rep3.share_field_elements(
            self.zk.fr, wtns[ni:],
            random.Random(common.seed_bytes(self.seed, b"shares")),
            device=self.device)

    def run_one(self, k):
        def prove_party(net, state, timings):
            drv = drivers.Rep3PlonkDriver(self.zk.fr, net, state)
            return plonk.prove(self.zk, drv, self.public,
                               self.shares[net.id], timings=timings)

        return common.rep3_round(self.seed, k, self.device, prove_party,
                                 self.counters, self.wanted)

    def release(self):
        self.shares = None

    def check(self, outputs, warm):
        vk = ref.vk(self.key_seed, self.domain_pow, self.n_additions)
        ok = common.check_proofs(
            outputs, warm, lambda p: ref.verify(vk, p, self.public[1:]))
        return ok, [("failed_proofs", ok.count(False), 0),
                    ("key_mismatches", self._key_mismatches(vk), 0)]

    def _key_mismatches(self, vk) -> int:
        zk = self.zk
        bad = sum(decode_g1_affine_mont(getattr(zk, f)) != vk[name]
                  for name, f in ZKEY_FIELDS.items())
        bad += decode_g2_affine_mont(zk.x2) != vk["X_2"]
        tau = ref.draw(self.key_seed, b"tau")
        rng = random.Random(common.seed_bytes(self.seed, b"key-samples"))
        for i in rng.sample(range(len(zk.p_tau)),
                            min(KEY_SAMPLES, len(zk.p_tau))):
            bad += decode_g1_affine_mont(zk.p_tau[i]) != G1.mul(
                G1.gen, pow(tau, i, ref.R))
        return int(bad)
