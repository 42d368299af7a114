"""A satisfiable snarkjs PLONK zkey (prover type 2), built with
cosnarks_tpu_torch alone, for the port's tests and chip_smoke.py:
`plonk_fixture(domain_pow, curve, n_additions, seed, device)` returns the
zkey bytes (cached under build/zkeys/), the snarkjs vk dict and the wtns;
`rep3_plonk_case(domain_pow, device)` sets up chip_smoke.py's Rep3 proof.

The circuit is a squaring chain x_{i+1} = x_i^2 with two public inputs,
x_0 and the chain's last value:
  - public gates: gate j has a = public signal j + 1 and qL = 1 (the
    prover's PI(X) = -sum buf_a[j] L_j cancels it);
  - chain gates: a = b = x_i, c = x_{i+1}, qM = 1, qO = -1;
  - addition gates: snarkjs "additions" are signals y_k = ca_k u_k + cb_k v_k
    the prover computes itself (u_k = y_{k-2} for k >= 2, so the prover's
    wave loop runs more than one wave); gate a = y_k, b = u_k, c = v_k,
    qL = 1, qR = -ca_k, qO = -cb_k;
  - unused slots take signal 0, whose value the prover zeroes; one padding
    row at least, whose slots map to themselves.
Sigma 1-3 follow the copy-constraint cycles over the cosets 1, k1 = 2 and
k2 = 3. Selectors, sigmas and the Lagrange polynomials of the public rows
are stored as Montgomery coefficients (n) plus evaluations on the 4n domain
(the port's ntt domains), p_tau = [tau^i]G1 for i < n + 6 and X_2 = [tau]G2
from a seeded tau, and the commitments are the port's msm().
"""

from __future__ import annotations

import hashlib
import os
import random
import struct
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from cosnarks_tpu_torch import resolve_device
from cosnarks_tpu_torch.ec import curve as ec
from cosnarks_tpu_torch.ec import msm
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs
from cosnarks_tpu_torch.groth16 import setup
from cosnarks_tpu_torch.groth16.prove import load_g1_array
from cosnarks_tpu_torch.io import jsonio, shared
from cosnarks_tpu_torch.io.binformat import limbs_to_le_bytes, write_container
from cosnarks_tpu_torch.io.zkey import (PLONK, PlonkZkey, g1_to_ints,
                                        g2_to_ints, parse_plonk_zkey)
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.plonk import drivers, verify
from cosnarks_tpu_torch.poly import ntt

CURVES = {"bn254": setup.BN254, "bls12_381": setup.BLS12_381}
K1, K2 = 2, 3
N_PUBLIC = 2


def _draw(seed: bytes, tag: bytes, p: int) -> int:
    h = hashlib.blake2b(seed + tag, digest_size=32).digest()
    return int.from_bytes(h, "big") % p


def _circuit(n: int, n_additions: int, seed: bytes, p: int):
    """Gates and witness: (rows of (a, b, c, qm, ql, qr, qo) with signal
    ids and standard-form selector ints, additions (a, b, ca, cb), the wtns
    values of the non-addition signals)."""
    m = n - N_PUBLIC - n_additions - 1  # chain gates; one padding row
    if m < 2:
        raise ValueError("domain too small for the chain and additions")
    # signals: 0 one, 1 = x_0, 2 = x_m (publics), 3.. = x_1 .. x_{m-1}
    def sig(i):
        return 1 if i == 0 else 2 if i == m else i + 2

    x = [_draw(seed, b"x0", p)]
    for _ in range(m):
        x.append(x[-1] * x[-1] % p)
    wtns = [1, x[0], x[m]] + x[1:m]
    n_base = len(wtns)
    rows = [(1, 0, 0, 0, 1, 0, 0), (2, 0, 0, 0, 1, 0, 0)]
    rows += [(sig(i), sig(i), sig(i + 1), 1, 0, 0, p - 1) for i in range(m)]
    adds = []
    for k in range(n_additions):
        u = n_base + k - 2 if k >= 2 else sig(k + 1)
        v = sig(k % m + 1)
        ca = _draw(seed, b"ca%d" % k, p)
        cb = _draw(seed, b"cb%d" % k, p)
        adds.append((u, v, ca, cb))
        rows.append((n_base + k, u, v, 0, 1, (p - ca) % p, (p - cb) % p))
    return rows, adds, wtns


def _sigmas(rows, n: int, w_pows: list[int], p: int):
    """sigma_1..3 evaluations on the n domain: every signal's slots (a
    slots of every row, then b, then c) form one cycle; padding rows map to
    themselves. Slot (s, j) is the value k_s w^j."""
    ks = (1, K1, K2)
    slots: dict[int, list[tuple[int, int]]] = {}
    for s in range(3):
        for j, row in enumerate(rows):
            slots.setdefault(row[s], []).append((s, j))
    sigma = [[ks[s] * w_pows[j] % p for j in range(n)] for s in range(3)]
    for cycle in slots.values():
        for i, (s, j) in enumerate(cycle):
            s2, j2 = cycle[(i + 1) % len(cycle)]
            sigma[s][j] = ks[s2] * w_pows[j2] % p
    return sigma


def _g1_limbs(fq, pt) -> np.ndarray:
    """Host affine point or None -> zkey (2, nq) Montgomery limbs."""
    if pt is None:
        return np.zeros((2, fq.nlimbs), np.uint32)
    return ints_to_limbs([fq.to_mont_int(c) for c in pt], fq.nlimbs)


def vk_from_zkey(zk: PlonkZkey) -> dict:
    """The snarkjs verification_key.json fields that plonk.verify reads."""
    fq = zk.fq
    return {
        "protocol": "plonk",
        "curve": "bn128" if zk.fr.name.startswith("bn254") else "bls12381",
        "nPublic": zk.n_public,
        "power": zk.domain_size.bit_length() - 1,
        "k1": str(zk.k1), "k2": str(zk.k2),
        **{name: jsonio.g1_to_json(g1_to_ints(fq, getattr(zk, attr)))
           for name, attr in (("Qm", "qm_c"), ("Ql", "ql_c"), ("Qr", "qr_c"),
                              ("Qo", "qo_c"), ("Qc", "qc_c"), ("S1", "s1_c"),
                              ("S2", "s2_c"), ("S3", "s3_c"))},
        "X_2": jsonio.g2_to_json(g2_to_ints(fq, zk.x2)),
    }


def build_zkey(domain_pow: int, curve: str = "bn254", n_additions: int = 0,
               seed: bytes = b"cosnarks-plonk", device=None):
    """(zkey bytes, wtns values) of the squaring-chain circuit."""
    device = resolve_device(device)
    g1, g2 = CURVES[curve]
    fr, fq = g1.scalar_field, g1.ops.field
    p = fr.p
    n = 1 << domain_pow
    rows, adds, wtns = _circuit(n, n_additions, seed, p)
    dom = ntt.groth16_domain(fr, n)
    dom4 = ntt.groth16_domain(fr, 4 * n)
    w_pows = dom.elements()

    tau = _draw(seed, b"tau", p)
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
        """[poly(tau)]G1 by the port's msm(), as zkey limbs."""
        pt = msm.msm(g1, p_tau_dev, mont.from_mont(fr, coeffs))
        return _g1_limbs(fq, ec.decode_points(
            g1, tuple(c[None] for c in pt))[0])

    def column(i):
        return [r[i] for r in rows] + [0] * (n - len(rows))

    sel = [poly4(column(i)) for i in range(3, 7)]  # qm, ql, qr, qo
    sel.append(poly4([0] * n))  # qc
    sig = [poly4(s) for s in _sigmas(rows, n, w_pows, p)]
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
    return write_container(b"zkey", 1, sections), wtns


def plonk_fixture(domain_pow: int, curve: str = "bn254", n_additions: int = 0,
                  seed: bytes = b"cosnarks-plonk", device=None):
    """(zkey bytes, snarkjs vk dict, wtns values), the zkey cached under
    build/zkeys/ by its parameters and this module's source, so that a
    changed fixture builds its zkey anew."""
    with open(__file__, "rb") as fh:
        tag = hashlib.blake2b(seed + fh.read(), digest_size=8).hexdigest()
    path = (setup.cache_home()
            / f"plonk_{curve}_{domain_pow}_{n_additions}_{tag}.zkey")
    if path.exists():
        data = path.read_bytes()
        p = CURVES[curve][0].scalar_field.p
        wtns = _circuit(1 << domain_pow, n_additions, seed, p)[2]
    else:
        data, wtns = build_zkey(domain_pow, curve, n_additions, seed, device)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)
    return data, vk_from_zkey(parse_plonk_zkey(data)), wtns



@dataclass
class Rep3PlonkCase:
    """chip_smoke.py's 3-party Rep3 PLONK proof (phase `rep3_plonk`, also
    traced by scripts/torch_plonk_profile.py): the zkey bytes and their
    parse, the vk, the public inputs, and `party(net)` -> (driver, public
    inputs, share) reading that party's `.shared` file."""
    zkey_bytes: bytes
    zk: PlonkZkey
    vk: dict
    wtns: list[int]
    public: list[int]
    party: Callable

    def check(self, proofs) -> None:
        """Raise unless every party returned the same proof and it
        verifies."""
        if not all(p == proofs[0] for p in proofs):
            raise AssertionError("PLONK parties disagree")
        if not verify.verify(self.vk, proofs[0], self.public):
            raise AssertionError("PLONK proof does not verify")


def rep3_plonk_case(domain_pow: int, device) -> Rep3PlonkCase:
    """The BN254 fixture with four additions, each party's witness split
    by split_witness_rep3 into `.shared` bytes, read back on `device`."""
    device = resolve_device(device)
    data, vk, w = plonk_fixture(domain_pow, "bn254", 4, b"chip-smoke-plonk",
                                device)
    zk = parse_plonk_zkey(data)
    ni = zk.n_public + 1
    files = shared.split_witness_rep3(zk.fr, w, ni, random.Random(0x9E3),
                                      device=device)

    def party(net):
        f = shared.read_shared_witness(files[net.id], device=device)
        state = rep3.Rep3State.setup(net, bytes([net.id + 0x31]) * 32,
                                     device=device)
        return (drivers.Rep3PlonkDriver(zk.fr, net, state), f.public_inputs,
                rep3.Share(f.share_a, f.share_b))

    return Rep3PlonkCase(data, zk, vk, w, w[1:ni], party)
