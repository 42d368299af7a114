"""snarkjs .zkey (Groth16 + PLONK) types and parsers: port of
cosnarks_tpu.io.zkey (numpy only; device tensors are made where the arrays
are used).

snarkjs stores zkey field elements and point coordinates in Montgomery
form with R = 2^(8*n8), the same representation as the device limbs, so
sections map straight into limb arrays.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..ff.bigint import limbs_to_int
from ..ff.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR, Field
from .binformat import (Container, le_bytes_to_limbs, limbs_to_le_bytes,
                        read_u32, write_container)

GROTH16 = 1
PLONK = 2

_FIELDS_BY_P = {
    BN254_FQ.p: BN254_FQ,
    BN254_FR.p: BN254_FR,
    BLS12_381_FQ.p: BLS12_381_FQ,
    BLS12_381_FR.p: BLS12_381_FR,
}


@dataclasses.dataclass
class Groth16Zkey:
    """All arrays are numpy uint32 16-bit limbs in Montgomery form.

    G1 arrays: (N, 2, nq) [x, y]; G2 arrays: (N, 2, 2, nq) [x(c0,c1), y(..)].
    The all-zero point encodes infinity (snarkjs convention).
    """

    fq: Field
    fr: Field
    n_vars: int
    n_public: int
    domain_size: int
    alpha_g1: np.ndarray
    beta_g1: np.ndarray
    beta_g2: np.ndarray
    gamma_g2: np.ndarray
    delta_g1: np.ndarray
    delta_g2: np.ndarray
    ic: np.ndarray  # (n_public+1) G1
    # sparse A/B matrices: per entry (matrix, constraint, signal, value)
    coeff_matrix: np.ndarray  # (ncoeffs,) uint32, 0=A 1=B
    coeff_row: np.ndarray  # constraint index
    coeff_col: np.ndarray  # signal index
    coeff_val: np.ndarray  # (ncoeffs, nr) Montgomery limbs
    a_query: np.ndarray  # (n_vars) G1
    b_g1_query: np.ndarray  # (n_vars) G1
    b_g2_query: np.ndarray  # (n_vars) G2
    c_query: np.ndarray  # (n_vars - n_public - 1) G1  (the l_query)
    h_query: np.ndarray  # (domain_size) G1


def _g1s(view, n8q) -> np.ndarray:
    return le_bytes_to_limbs(view, n8q).reshape(-1, 2, n8q // 2)


def _g2s(view, n8q) -> np.ndarray:
    return le_bytes_to_limbs(view, n8q).reshape(-1, 2, 2, n8q // 2)


def parse_groth16_zkey(data: bytes) -> Groth16Zkey:
    c = Container(data, b"zkey")
    (prover_type,) = np.frombuffer(c.section(1), dtype="<u4")
    if prover_type != GROTH16:
        raise ValueError(f"not a groth16 zkey (prover type {prover_type})")
    h = c.section(2)
    off = 0
    n8q, off = read_u32(h, off)
    q = limbs_to_int(le_bytes_to_limbs(h[off : off + n8q], n8q)[0])
    off += n8q
    n8r, off = read_u32(h, off)
    r = limbs_to_int(le_bytes_to_limbs(h[off : off + n8r], n8r)[0])
    off += n8r
    fq = _FIELDS_BY_P[q]
    fr = _FIELDS_BY_P[r]
    n_vars, off = read_u32(h, off)
    n_public, off = read_u32(h, off)
    domain_size, off = read_u32(h, off)

    def g1(o):
        return _g1s(h[o : o + 2 * n8q], n8q)[0], o + 2 * n8q

    def g2(o):
        return _g2s(h[o : o + 4 * n8q], n8q)[0], o + 4 * n8q

    alpha_g1, off = g1(off)
    beta_g1, off = g1(off)
    beta_g2, off = g2(off)
    gamma_g2, off = g2(off)
    delta_g1, off = g1(off)
    delta_g2, off = g2(off)

    cv = c.section(4)
    ncoeffs, _ = read_u32(cv, 0)
    rec = np.frombuffer(cv, dtype=np.uint8, count=ncoeffs * (12 + n8r), offset=4)
    rec = rec.reshape(ncoeffs, 12 + n8r)
    meta = rec[:, :12].copy().view("<u4").reshape(ncoeffs, 3)
    vals = np.ascontiguousarray(rec[:, 12:]).view("<u2").astype(np.uint32)

    # sparse_matvec (groth16/witness_map.py) accumulates limb products in
    # uint32 lanes: per (matrix, row) entry counts must stay < 2^16 or the
    # lazy segment sum overflows silently. Fail loudly here instead.
    if ncoeffs:
        key = meta[:, 0].astype(np.int64) * domain_size + meta[:, 1]
        per_row = np.bincount(key)
        if per_row.max(initial=0) >= (1 << 16):
            raise ValueError(
                "zkey has a constraint row with >= 2^16 coefficients; "
                "lazy uint32 accumulation would overflow (chunked reduction "
                "not implemented)"
            )

    return Groth16Zkey(
        fq=fq,
        fr=fr,
        n_vars=n_vars,
        n_public=n_public,
        domain_size=domain_size,
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        ic=_g1s(c.section(3), n8q),
        coeff_matrix=meta[:, 0].copy(),
        coeff_row=meta[:, 1].copy(),
        coeff_col=meta[:, 2].copy(),
        coeff_val=vals,
        a_query=_g1s(c.section(5), n8q),
        b_g1_query=_g1s(c.section(6), n8q),
        b_g2_query=_g2s(c.section(7), n8q),
        c_query=_g1s(c.section(8), n8q),
        h_query=_g1s(c.section(9), n8q),
    )


def load_groth16_zkey(path) -> Groth16Zkey:
    with open(path, "rb") as f:
        return parse_groth16_zkey(f.read())


def write_groth16_zkey(zk: Groth16Zkey) -> bytes:
    """A Groth16Zkey's arrays as a snarkjs-layout zkey file, the sections
    parse_groth16_zkey reads (the port's own writer: a zkey made by
    groth16.setup can go to the CLI, which reads zkeys from files)."""
    def raw(a):
        return limbs_to_le_bytes(a.reshape(-1, a.shape[-1]))

    header = b"".join([
        struct.pack("<I", 2 * zk.fq.nlimbs), raw(zk.fq.p_limbs[None]),
        struct.pack("<I", 2 * zk.fr.nlimbs), raw(zk.fr.p_limbs[None]),
        struct.pack("<III", zk.n_vars, zk.n_public, zk.domain_size),
        *(raw(getattr(zk, k)) for k in ("alpha_g1", "beta_g1", "beta_g2",
                                         "gamma_g2", "delta_g1",
                                         "delta_g2"))])
    coeffs = struct.pack("<I", len(zk.coeff_row)) + b"".join(
        struct.pack("<III", m, r, c) + raw(v[None])
        for m, r, c, v in zip(zk.coeff_matrix, zk.coeff_row, zk.coeff_col,
                              zk.coeff_val))
    sections = [(1, struct.pack("<I", GROTH16)), (2, header), (3, raw(zk.ic)),
                (4, coeffs)]
    sections += [(5 + i, raw(getattr(zk, k))) for i, k in enumerate(
        ("a_query", "b_g1_query", "b_g2_query", "c_query", "h_query"))]
    return write_container(b"zkey", 1, sections)


# -- host-form helpers (for the verifier / vk export) -----------------------

def g1_to_ints(fq: Field, pt: np.ndarray):
    """Montgomery limb G1 point -> host affine int pair or None (infinity)."""
    x = fq.from_mont_int(limbs_to_int(pt[0]))
    y = fq.from_mont_int(limbs_to_int(pt[1]))
    if x == 0 and y == 0:
        return None
    return (x, y)


def g2_to_ints(fq: Field, pt: np.ndarray):
    x = (fq.from_mont_int(limbs_to_int(pt[0, 0])),
         fq.from_mont_int(limbs_to_int(pt[0, 1])))
    y = (fq.from_mont_int(limbs_to_int(pt[1, 0])),
         fq.from_mont_int(limbs_to_int(pt[1, 1])))
    if x == (0, 0) and y == (0, 0):
        return None
    return (x, y)


# -- PLONK zkey ------------------------------------------------------------

@dataclasses.dataclass
class PlonkZkey:
    """snarkjs PLONK zkey (prover type 2). All limb arrays are Montgomery.

    Sections (snarkjs zkey format, mirrored from the external circom-types
    crate the reference uses, co-plonk/src/lib.rs:5):
      2 header: n8q,q,n8r,r,nVars,nPublic,domainSize,nAdditions,
                nConstraints,k1,k2,QM,QL,QR,QO,QC,S1,S2,S3 (G1), X2 (G2)
      3 additions: nAdditions x (u32 a, u32 b, Fr ca, Fr cb)
      4/5/6 A/B/C wire maps: nConstraints x u32
      7..11 QM/QL/QR/QO/QC: domain coeffs + 4*domain evals
      12 sigma1|2|3: 3 x (coeffs + 4n evals)
      13 lagrange: max(nPublic,1)? x (coeffs + 4n evals)
      14 p_tau: (domain + 6) G1 points
    """

    fq: Field
    fr: Field
    n_vars: int
    n_public: int
    domain_size: int
    n_additions: int
    n_constraints: int
    k1: int  # host ints (standard form)
    k2: int
    qm_c: np.ndarray  # commitments (Montgomery limb G1)
    ql_c: np.ndarray
    qr_c: np.ndarray
    qo_c: np.ndarray
    qc_c: np.ndarray
    s1_c: np.ndarray
    s2_c: np.ndarray
    s3_c: np.ndarray
    x2: np.ndarray  # G2
    add_a: np.ndarray  # (n_additions,) u32
    add_b: np.ndarray
    add_ca: np.ndarray  # (n_additions, nr) Montgomery limbs
    add_cb: np.ndarray
    map_a: np.ndarray  # (n_constraints,) u32
    map_b: np.ndarray
    map_c: np.ndarray
    qm: tuple  # (coeffs (n, nr), evals4 (4n, nr)) Montgomery limbs
    ql: tuple
    qr: tuple
    qo: tuple
    qc: tuple
    s1: tuple
    s2: tuple
    s3: tuple
    lagrange: list  # [(coeffs, evals4)] per public input
    p_tau: np.ndarray  # (domain+6) G1


def _poly4(view, off, n, n8r):
    nr = n8r // 2
    coeffs = le_bytes_to_limbs(view[off : off + n * n8r], n8r).reshape(n, nr)
    off += n * n8r
    evals = le_bytes_to_limbs(view[off : off + 4 * n * n8r], n8r).reshape(
        4 * n, nr
    )
    return (coeffs, evals), off + 4 * n * n8r


def parse_plonk_zkey(data: bytes) -> PlonkZkey:
    c = Container(data, b"zkey")
    (prover_type,) = np.frombuffer(c.section(1), dtype="<u4")
    if prover_type != PLONK:
        raise ValueError(f"not a plonk zkey (prover type {prover_type})")
    h = c.section(2)
    off = 0
    n8q, off = read_u32(h, off)
    q = limbs_to_int(le_bytes_to_limbs(h[off : off + n8q], n8q)[0])
    off += n8q
    n8r, off = read_u32(h, off)
    r = limbs_to_int(le_bytes_to_limbs(h[off : off + n8r], n8r)[0])
    off += n8r
    fq = _FIELDS_BY_P[q]
    fr = _FIELDS_BY_P[r]
    n_vars, off = read_u32(h, off)
    n_public, off = read_u32(h, off)
    domain_size, off = read_u32(h, off)
    n_additions, off = read_u32(h, off)
    n_constraints, off = read_u32(h, off)

    def fr_scalar(o):
        v = limbs_to_int(le_bytes_to_limbs(h[o : o + n8r], n8r)[0])
        return fr.from_mont_int(v), o + n8r

    def g1(o):
        return _g1s(h[o : o + 2 * n8q], n8q)[0], o + 2 * n8q

    k1, off = fr_scalar(off)
    k2, off = fr_scalar(off)
    qm_c, off = g1(off)
    ql_c, off = g1(off)
    qr_c, off = g1(off)
    qo_c, off = g1(off)
    qc_c, off = g1(off)
    s1_c, off = g1(off)
    s2_c, off = g1(off)
    s3_c, off = g1(off)
    x2 = _g2s(h[off : off + 4 * n8q], n8q)[0]

    adds = c.section(3)
    nr = n8r // 2
    add_a = np.zeros(n_additions, np.uint32)
    add_b = np.zeros(n_additions, np.uint32)
    add_ca = np.zeros((n_additions, nr), np.uint32)
    add_cb = np.zeros((n_additions, nr), np.uint32)
    stride = 8 + 2 * n8r
    for i in range(n_additions):
        o = i * stride
        add_a[i], _ = read_u32(adds, o)
        add_b[i], _ = read_u32(adds, o + 4)
        add_ca[i] = le_bytes_to_limbs(adds[o + 8 : o + 8 + n8r], n8r)[0]
        add_cb[i] = le_bytes_to_limbs(
            adds[o + 8 + n8r : o + 8 + 2 * n8r], n8r
        )[0]

    def umap(sid):
        return np.frombuffer(c.section(sid), dtype="<u4").astype(np.uint32)

    qm, _ = _poly4(c.section(7), 0, domain_size, n8r)
    ql, _ = _poly4(c.section(8), 0, domain_size, n8r)
    qr, _ = _poly4(c.section(9), 0, domain_size, n8r)
    qo, _ = _poly4(c.section(10), 0, domain_size, n8r)
    qc, _ = _poly4(c.section(11), 0, domain_size, n8r)
    sig = c.section(12)
    s1, o = _poly4(sig, 0, domain_size, n8r)
    s2, o = _poly4(sig, o, domain_size, n8r)
    s3, o = _poly4(sig, o, domain_size, n8r)
    lag_view = c.section(13)
    n_lag = len(lag_view) // (5 * domain_size * n8r)
    lagrange = []
    o = 0
    for _ in range(n_lag):
        lp, o = _poly4(lag_view, o, domain_size, n8r)
        lagrange.append(lp)

    return PlonkZkey(
        fq=fq, fr=fr, n_vars=n_vars, n_public=n_public,
        domain_size=domain_size, n_additions=n_additions,
        n_constraints=n_constraints, k1=k1, k2=k2,
        qm_c=qm_c, ql_c=ql_c, qr_c=qr_c, qo_c=qo_c, qc_c=qc_c,
        s1_c=s1_c, s2_c=s2_c, s3_c=s3_c, x2=x2,
        add_a=add_a, add_b=add_b, add_ca=add_ca, add_cb=add_cb,
        map_a=umap(4), map_b=umap(5), map_c=umap(6),
        qm=qm, ql=ql, qr=qr, qo=qo, qc=qc, s1=s1, s2=s2, s3=s3,
        lagrange=lagrange,
        p_tau=_g1s(c.section(14), n8q),
    )


def load_plonk_zkey(path) -> PlonkZkey:
    with open(path, "rb") as f:
        return parse_plonk_zkey(f.read())
