"""Synthetic Groth16 trusted setup (snarkjs zkey conventions) for
benchmarks and tests: port of cosnarks_tpu.groth16.setup.

Builds a Groth16Zkey for a squaring-chain circuit (w_{i+1} = w_i^2) of any
constraint count, over BN254 (the default) or BLS12-381: public-input
binding rows appended to A, the snarkjs root-of-unity domain, and h_query
in the odd-coset Lagrange basis matching the CircomReduction witness map.
The toxic waste comes from a seed and is discarded. Query points come from
batched scalar muls on the device (a windowed fixed-base table above 2048
scalars); the zkey can be cached on disk.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..ec import curve as ec
from ..ec import curves
from ..ff.bigint import ints_to_limbs
from ..io.zkey import Groth16Zkey
from ..poly import ntt


def _batch_inv(vals, p):
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % p
    inv = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * vals[i] % p
    return out


_FB_W = 8  # fixed-base window width (bits); 16-bit limbs split evenly

_fb_tables: dict = {}


def _limbs(scalars, F, device):
    arr = ints_to_limbs([s % F.p for s in scalars], F.nlimbs)
    return torch.as_tensor(arr.astype(np.int64), device=device)


def _generator(spec, count, device):
    gen = ec.encode_points(spec, [spec.generator], device=device)
    return tuple(x[0].expand((count,) + x.shape[1:]) for x in gen)


def _fixed_base_table(spec, device):
    """Windowed fixed-base table T[j][d] = [d * 2^(8j)] G (Jacobian): one
    batched double-and-add over nwin*255 lanes; d = 0 rows are infinity
    (Z = 0), which the complete `add` absorbs."""
    key = (spec.name, device)
    if key in _fb_tables:
        return _fb_tables[key]
    F = spec.scalar_field
    nwin = F.nlimbs * 16 // _FB_W
    ds = [(d << (_FB_W * j)) % F.p
          for j in range(nwin) for d in range(1, 1 << _FB_W)]
    ks = _limbs(ds, F, device)
    pts = ec.scalar_mul(spec, _generator(spec, len(ds), device), ks)
    full = []
    for x in pts:
        arr = x.reshape((nwin, (1 << _FB_W) - 1) + x.shape[1:])
        z = torch.zeros((nwin, 1) + x.shape[1:], dtype=x.dtype,
                        device=device)  # (0,0,0) = inf
        full.append(torch.cat([z, arr], dim=1))
    table = tuple(full)
    _fb_tables[key] = table
    return table


def _fb_chunk(spec, table, digits):
    """Sum of table windows selected by per-scalar digits: (n, nwin)
    -> n affine points, nwin-1 complete adds."""
    nwin = digits.shape[1]
    acc = tuple(x[0][digits[:, 0]] for x in table)
    for j in range(1, nwin):
        q = tuple(x[j][digits[:, j]] for x in table)
        acc = ec.add(spec, acc, q)
    return ec.to_affine(spec, acc)


def _fixed_base_g1(spec, scalars: list[int], device, chunk: int | None = None):
    """[s]G for a list of standard-form scalars, batched on the device;
    returns host numpy int64 (X, Y, Z) affine arrays."""
    F = spec.scalar_field
    if chunk is None:
        chunk = (1 << 17) if spec.ops.coord_ndim == 1 else (1 << 15)
    if len(scalars) <= 2048 and (spec.name, device) not in _fb_tables:
        # below the table's amortization point: direct double-and-add
        ks = _limbs(scalars, F, device)
        pts = ec.to_affine(spec, ec.scalar_mul(
            spec, _generator(spec, len(scalars), device), ks))
        return tuple(x.cpu().numpy() for x in pts)
    table = _fixed_base_table(spec, device)
    outs = []
    for lo in range(0, len(scalars), chunk):
        limbs = _limbs(scalars[lo:lo + chunk], F, device)
        digits = torch.stack([limbs & 255, limbs >> 8], dim=-1).reshape(
            limbs.shape[0], -1)
        pts = _fb_chunk(spec, table, digits)
        outs.append(tuple(x.cpu().numpy() for x in pts))
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(3))


def _to_zkey(pts) -> np.ndarray:
    """Affine (X, Y, Z) -> zkey (N, 2, ...) uint32 layout; Z==0 rows become
    all-zero (snarkjs infinity encoding)."""
    X, Y, Z = pts
    fin = ~np.all(Z.reshape(Z.shape[0], -1) == 0, axis=-1)
    arr = np.stack([X, Y], axis=1).astype(np.uint32)
    arr[~fin] = 0
    return arr


def chain_circom(n_constraints: int) -> str:
    """synthetic_zkey(n_constraints)'s circuit as circom source. Its wire
    order 1, x (public), s[0..n-1] is the zkey's witness layout, so the
    circom VM's witness of {"x": 3} proves against that zkey."""
    return f"""pragma circom 2.0.0;
template Chain(n) {{
    signal input x;
    signal s[n];
    s[0] <== x * x;
    for (var i = 1; i < n; i++) {{
        s[i] <== s[i - 1] * s[i - 1];
    }}
}}
component main {{public [x]}} = Chain({n_constraints});
"""


BN254 = (curves.BN254_G1, curves.BN254_G2)
BLS12_381 = (curves.BLS12_381_G1, curves.BLS12_381_G2)


def synthetic_zkey(n_constraints: int, seed: bytes = b"cosnarks-bench",
                   n_public: int = 1, device=None,
                   curve_pair=BN254) -> tuple[Groth16Zkey, list[int]]:
    """Returns (zkey, witness) for the squaring chain with x = 3, over the
    (G1, G2) curves of `curve_pair` (BN254 or BLS12_381)."""
    device = resolve_device(device)
    g1, g2 = curve_pair
    fr, fq = g1.scalar_field, g1.ops.field
    p = fr.p
    ncon, npub = n_constraints, n_public
    n_vars = ncon + 2
    N = 1
    while N < ncon + npub + 1:
        N *= 2

    def draw(tag):
        h = hashlib.blake2b(seed + tag, digest_size=32).digest()
        return int.from_bytes(h, "big") % p

    tau, alpha, beta, gamma, delta = (draw(t) for t in
                                      (b"tau", b"alpha", b"beta", b"gamma",
                                       b"delta"))
    dom = ntt.groth16_domain(fr, N)
    omega = dom.group_gen
    rho = ntt.groth16_shift_root(fr, dom)

    # Lagrange values over the base domain:
    # L_j(tau) = Z(tau) w^j / (N (tau - w^j))
    pow_w = [1] * N
    for j in range(1, N):
        pow_w[j] = pow_w[j - 1] * omega % p
    z_tau = (pow(tau, N, p) - 1) % p
    dinv = _batch_inv([(tau - wj) % p for wj in pow_w], p)
    n_inv = pow(N, -1, p)
    L = [z_tau * wj % p * di % p * n_inv % p for wj, di in zip(pow_w, dinv)]

    # QAP values per signal (squaring chain + snarkjs public binding rows)
    A = [0] * n_vars
    B = [0] * n_vars
    Cv = [0] * n_vars
    for j in range(ncon):
        A[j + 1] = (A[j + 1] + L[j]) % p
        B[j + 1] = (B[j + 1] + L[j]) % p
        Cv[j + 2] = (Cv[j + 2] + L[j]) % p
    for i in range(npub + 1):
        A[i] = (A[i] + L[ncon + i]) % p

    dinv_delta = pow(delta, -1, p)
    dinv_gamma = pow(gamma, -1, p)

    a_q = _fixed_base_g1(g1, A, device)
    b1_q = _fixed_base_g1(g1, B, device)
    lc = [(beta * A[i] + alpha * B[i] + Cv[i]) % p for i in range(n_vars)]
    ic_q = _fixed_base_g1(g1, [v * dinv_gamma % p for v in lc[:npub + 1]],
                          device)
    l_q = _fixed_base_g1(g1, [v * dinv_delta % p for v in lc[npub + 1:]],
                         device)

    # h_query over the shifted (odd-coset) Lagrange basis
    rhoN = pow(rho, N, p)
    zshift_tau = (pow(tau, N, p) - rhoN) % p
    pts = [rho * wj % p for wj in pow_w]
    hinv = _batch_inv([(tau - pt) % p for pt in pts], p)
    scale = (z_tau * dinv_delta % p * pow((rhoN - 1) % p, -1, p)
             % p * n_inv % p * zshift_tau % p * pow(rhoN, -1, p) % p)
    h_q = _fixed_base_g1(g1, [scale * pt % p * hi % p
                              for pt, hi in zip(pts, hinv)], device)

    b2_q = _fixed_base_g1(g2, B, device)

    onesies = _fixed_base_g1(g1, [alpha, beta, delta], device)
    alpha_g1, beta_g1, delta_g1 = _to_zkey(onesies)
    twos = _fixed_base_g1(g2, [beta, gamma, delta], device)
    beta_g2, gamma_g2, delta_g2 = _to_zkey(twos)

    # COO coefficient matrices (A and B), values in the zkey's
    # double-Montgomery form: witness_map applies one Montgomery reduction
    one_zkey = ints_to_limbs(
        [fr.to_mont_int(fr.to_mont_int(1))], fr.nlimbs)[0]
    rows_a = list(range(ncon)) + list(range(ncon, ncon + npub + 1))
    cols_a = list(range(1, ncon + 1)) + list(range(npub + 1))
    rows_b = list(range(ncon))
    cols_b = list(range(1, ncon + 1))
    nco = len(rows_a) + len(rows_b)
    zkey = Groth16Zkey(
        fq=fq, fr=fr, n_vars=n_vars, n_public=npub, domain_size=N,
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        gamma_g2=gamma_g2, delta_g1=delta_g1, delta_g2=delta_g2,
        ic=_to_zkey(ic_q),
        coeff_matrix=np.array([0] * len(rows_a) + [1] * len(rows_b),
                              dtype=np.uint32),
        coeff_row=np.array(rows_a + rows_b, dtype=np.uint32),
        coeff_col=np.array(cols_a + cols_b, dtype=np.uint32),
        coeff_val=np.broadcast_to(one_zkey, (nco, fr.nlimbs)).copy(),
        a_query=_to_zkey(a_q), b_g1_query=_to_zkey(b1_q),
        b_g2_query=_to_zkey(b2_q), c_query=_to_zkey(l_q),
        h_query=_to_zkey(h_q),
    )

    # witness: squaring chain from x = 3
    w = [1, 3]
    for _ in range(ncon):
        w.append(w[-1] * w[-1] % p)
    return zkey, w[:n_vars]


_ZKEY_ARRAYS = ("alpha_g1", "beta_g1", "beta_g2", "gamma_g2", "delta_g1",
                "delta_g2", "ic", "coeff_matrix", "coeff_row", "coeff_col",
                "coeff_val", "a_query", "b_g1_query", "b_g2_query",
                "c_query", "h_query")


def cache_home() -> Path:
    """Default zkey cache: build/zkeys beside the package (listed in
    .gitignore), so nothing is written outside the checkout."""
    path = Path(__file__).resolve().parent.parent.parent / "build" / "zkeys"
    path.mkdir(parents=True, exist_ok=True)
    return path


def cache_path(n_constraints: int, cache_dir=None,
               curve_pair=BN254) -> Path:
    """The .npz file that caches synthetic_zkey(n_constraints) over
    `curve_pair`, named after the curve."""
    cache_dir = Path(cache_dir) if cache_dir is not None else cache_home()
    cache_dir.mkdir(parents=True, exist_ok=True)
    tag = curve_pair[0].name.removesuffix("_g1")
    return cache_dir / f"synthetic_{tag}_{n_constraints}.npz"


def cached_synthetic_zkey(n_constraints: int, cache_dir=None, device=None,
                          curve_pair=BN254):
    """synthetic_zkey(n_constraints, curve_pair=curve_pair), cached at
    `cache_path`."""
    g1 = curve_pair[0]
    path = cache_path(n_constraints, cache_dir, curve_pair)
    if path.exists():
        data = np.load(path)
        zkey = Groth16Zkey(
            fq=g1.ops.field, fr=g1.scalar_field, n_vars=int(data["n_vars"]),
            n_public=int(data["n_public"]),
            domain_size=int(data["domain_size"]),
            **{k: data[k] for k in _ZKEY_ARRAYS})
        return zkey, [int(x) for x in data["witness"]]
    zkey, w = synthetic_zkey(n_constraints, device=device,
                             curve_pair=curve_pair)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, n_vars=zkey.n_vars, n_public=zkey.n_public,
             domain_size=zkey.domain_size,
             witness=np.array([str(x) for x in w]),
             **{k: getattr(zkey, k) for k in _ZKEY_ARRAYS})
    os.replace(tmp, path)
    return zkey, w
