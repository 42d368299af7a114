"""One party's share MSM at the size of the flagship key: what each Rep3
party of a Groth16 proof runs for each of its G1 queries,
`drivers.msm_half` -> `ec/msm.py` `msm()` at its default window, on
2^points_log2 affine BN254 G1 points with additive half-share scalars.

Set-up makes everything on the card from the seed with one torch.Generator:
the points' discrete logs k_i, the points [k_i]G (the program's
`scalar_mul` and `to_affine`, in chunks), and `scalar_sets` sets of
Montgomery-form scalars, uniform below 0x3064 * 2^240 (a Rep3 half-share is
uniform in Fr; this range holds 0.99992 of it). The window's MSMs take the
sets in turn.

The check, after the window, with the reference alone: every MSM's point
equals [sum_i s_i k_i]G for its set.
"""

from __future__ import annotations

import torch

from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec.curves import BN254_G1
from cosnarks_tpu_torch.groth16 import drivers

from ..reference import msm as ref
from ..reference.bn254 import decode_g1_jacobian_mont, limbs_to_ints
from . import common

TOP_LIMB_BOUND = 0x3064  # r's top 16-bit limb is 0x3064
POINT_CHUNK = 1 << 18


def _uniform_limbs(n: int, gen, device):
    """(n, 16) int64 16-bit limbs of values uniform below 0x3064 * 2^240."""
    x = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=device,
                      dtype=torch.int64)
    x[:, 15] = torch.randint(0, TOP_LIMB_BOUND, (n,), generator=gen,
                             device=device, dtype=torch.int64)
    return x


class Job:
    noun = "MSM"

    def __init__(self, config, mix, seed, device, wanted, counters):
        self.seed = seed
        self.device = device
        self.n = 1 << mix["points_log2"]
        self.n_sets = mix["scalar_sets"]
        self.items_per_job = self.n
        self.distinct_inputs = self.n_sets  # job k takes set k % n_sets

    def setup(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.dlogs = _uniform_limbs(self.n, gen, self.device)
        g = ec.encode_points(BN254_G1, [BN254_G1.generator],
                             device=self.device)
        parts = []
        for lo in range(0, self.n, POINT_CHUNK):
            k = self.dlogs[lo:lo + POINT_CHUNK]
            base = tuple(c[0].expand((k.shape[0],) + c.shape[1:]) for c in g)
            parts.append(ec.to_affine(BN254_G1,
                                      ec.scalar_mul(BN254_G1, base, k)))
        self.points = tuple(torch.cat([p[i] for p in parts]).contiguous()
                            for i in range(3))
        self.scalars = [_uniform_limbs(self.n, gen, self.device)
                        for _ in range(self.n_sets)]
        common.sync(self.device)

    def run_one(self, k):
        s = k % self.n_sets
        out = drivers.msm_half(BN254_G1, self.points, self.scalars[s])
        common.sync(self.device)
        return s, out

    def release(self):
        # the reference needs the inputs on the host; the program's points
        # and state go
        self.dlogs_host = self.dlogs.cpu().numpy()
        self.scalars_host = [s.cpu().numpy() for s in self.scalars]
        self.points = self.scalars = self.dlogs = None

    def check(self, outputs, warm):
        dlogs = limbs_to_ints(self.dlogs_host)
        want = {}
        ok = []
        for s, out in outputs:
            if s not in want:
                want[s] = ref.expected(dlogs,
                                       limbs_to_ints(self.scalars_host[s]))
            x, y, z = (limbs_to_ints(c.cpu().numpy())[0] for c in out)
            ok.append(decode_g1_jacobian_mont(x, y, z) == want[s])
        return ok, [("wrong_msms", ok.count(False), 0)]
