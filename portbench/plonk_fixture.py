"""The PLONK cells' key: a satisfiable snarkjs PLONK zkey (prover type 2) of
the circuit in `reference/plonk.py`, built from a seed on the card.

A frozen copy of the key-building code in the repository's
`scripts/torch_plonk_fixture.py` without its on-disk cache (the key depends
on each run's seed). Selectors, sigmas and the Lagrange polynomials of the
public rows are stored as Montgomery coefficients (n) plus evaluations on
the 4n domain, p_tau = [tau^i]G1 for i < n + 6 and X_2 = [tau]G2 from the
seed's tau; the commitments are the program's msm(). The key is written as
snarkjs zkey bytes and parsed back by the program, as a party loads its
key file.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import msm
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs
from cosnarks_tpu_torch.groth16 import setup
from cosnarks_tpu_torch.groth16.prove import load_g1_array
from cosnarks_tpu_torch.io.binformat import limbs_to_le_bytes, write_container
from cosnarks_tpu_torch.io.zkey import PLONK, parse_plonk_zkey
from cosnarks_tpu_torch.poly import ntt

from .reference.plonk import K1, K2, N_PUBLIC, circuit, draw, sigmas


def _g1_limbs(fq, pt) -> np.ndarray:
    """Host affine point or None -> zkey (2, nq) Montgomery limbs."""
    if pt is None:
        return np.zeros((2, fq.nlimbs), np.uint32)
    return ints_to_limbs([fq.to_mont_int(c) for c in pt], fq.nlimbs)


def build_zkey(domain_pow: int, n_additions: int, seed: bytes, device):
    """(parsed PlonkZkey, wtns values) of the circuit over BN254."""
    g1, g2 = setup.BN254
    fr, fq = g1.scalar_field, g1.ops.field
    p = fr.p
    n = 1 << domain_pow
    rows, adds, wtns = circuit(n, n_additions, seed, p)
    dom = ntt.groth16_domain(fr, n)
    dom4 = ntt.groth16_domain(fr, 4 * n)
    w_pows = dom.elements()

    tau = draw(seed, b"tau", p)
    tau_pows = [1]
    for _ in range(n + 5):
        tau_pows.append(tau_pows[-1] * tau % p)
    p_tau = setup._to_zkey(setup._fixed_base_g1(g1, tau_pows, device))
    x2 = setup._to_zkey(setup._fixed_base_g1(g2, [tau], device))[0]
    p_tau_dev = load_g1_array(g1, p_tau[:n], device)

    def poly4(evals: list[int]):
        """Row values -> (coeffs, evals on the 4n domain), Montgomery."""
        coeffs = dom.ifft(mont.encode(fr, evals, device=device))
        return coeffs, dom4.fft(torch.cat([coeffs, mont.zeros(
            fr, (3 * n,), device=device)]))

    def commit(coeffs) -> np.ndarray:
        pt = msm.msm(g1, p_tau_dev, mont.from_mont(fr, coeffs))
        return _g1_limbs(fq, ec.decode_points(
            g1, tuple(c[None] for c in pt))[0])

    def column(i):
        return [r[i] for r in rows] + [0] * (n - len(rows))

    sel = [poly4(column(i)) for i in range(3, 7)]  # qm, ql, qr, qo
    sel.append(poly4([0] * n))  # qc
    sig = [poly4(s) for s in sigmas(rows, n, w_pows, p)]
    lag = [poly4([1 if j == i else 0 for j in range(n)])
           for i in range(N_PUBLIC)]
    commits = [commit(c) for c, _ in sel + sig]

    n8q, n8r = 2 * fq.nlimbs, 2 * fr.nlimbs

    def fe(vals, F):
        return limbs_to_le_bytes(ints_to_limbs(vals, F.nlimbs))

    def polys(ps):
        return b"".join(limbs_to_le_bytes(c.cpu().numpy())
                        + limbs_to_le_bytes(e.cpu().numpy()) for c, e in ps)

    header = b"".join([
        struct.pack("<I", n8q), fe([fq.p], fq), struct.pack("<I", n8r),
        fe([p], fr),
        struct.pack("<5I", len(wtns) + len(adds), N_PUBLIC, n, len(adds),
                    len(rows)),
        fe([fr.to_mont_int(K1), fr.to_mont_int(K2)], fr),
        *(limbs_to_le_bytes(c) for c in commits),
        limbs_to_le_bytes(x2.reshape(4, -1)),
    ])
    additions = b"".join(
        struct.pack("<II", a, b) + fe([fr.to_mont_int(ca),
                                       fr.to_mont_int(cb)], fr)
        for a, b, ca, cb in adds)
    sections = [(1, struct.pack("<I", PLONK)), (2, header), (3, additions)]
    sections += [(4 + s, np.array([r[s] for r in rows], "<u4").tobytes())
                 for s in range(3)]
    sections += [(7 + i, polys([sel[i]])) for i in range(5)]
    sections += [(12, polys(sig)), (13, polys(lag)),
                 (14, limbs_to_le_bytes(p_tau.reshape(-1, fq.nlimbs)))]
    return parse_plonk_zkey(write_container(b"zkey", 1, sections)), wtns
