"""Port of `cosnarks_tpu.honk.crs`: the `.dat` format, the host known-tau
CRS, `cache_home` and `_check_local_crs` are copied unchanged. New here: a
CRS can hold its monomials once as Jacobian tensors on a device
(`Crs.to(device)`), and `local_crs(n, device=...)` makes the n products
tau^i * G1 on that device in one batched `curve.scalar_mul` (K2 on the
card) over n lanes. `polyops.commit` runs `msm()` on a CRS that has device
points and the host Pippenger on one that has none.

KZG structured reference strings for UltraHonk.

Barretenberg `.dat` flat-file parsing (co-noir-common/src/crs/parse.rs:
each G1 monomial is 64 bytes, x then y, each coordinate big-endian 32
bytes; G2 is 128 bytes, the Fq2 x then y with c0/c1 each 32-byte
big-endian after the 32-byte-chunk endianness flip + arkworks
little-endian decode — net effect: the file holds big-endian c0 || c1).

The Aztec ignition G1 file is multi-GB and fetched at runtime by the
reference (`download_g1_crs`, co-noir/src/lib.rs); in the zero-egress
build environment we additionally support a *local known-tau* CRS
(`local_crs`) for self-consistent prove/verify: monomials = tau^i * G1,
g2_x = tau * G2. Proofs under a local CRS verify with the real pairing
check but are not byte-identical to Aztec-CRS proofs (commitments differ);
transcript/layout compatibility is exercised regardless.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..ec import curve as ec
from ..ec import curves
from ..ec.host import host_curve
from ..ff.bigint import ints_to_limbs

G2_DAT = os.path.join(os.path.dirname(__file__), "data", "bn254_g2.dat")


def _g1_from_bytes(chunk: bytes):
    x = int.from_bytes(chunk[0:32], "big")
    y = int.from_bytes(chunk[32:64], "big")
    if x == 0 and y == 0:
        return None
    return (x, y)


def read_g1_dat(path: str, n: int) -> list:
    """First n monomials from a Barretenberg bn254_g1.dat flat file."""
    pts = []
    with open(path, "rb") as fh:
        data = fh.read(64 * n)
    if len(data) < 64 * n:
        raise ValueError(f"CRS file too small: needed {n} points")
    for i in range(n):
        pts.append(_g1_from_bytes(data[64 * i:64 * i + 64]))
    return pts


def write_g1_dat(path: str, pts: list) -> None:
    with open(path, "wb") as fh:
        for pt in pts:
            x, y = (0, 0) if pt is None else pt
            fh.write(int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big"))


def read_g2_dat(path: str = G2_DAT):
    """[tau]_2 from bn254_g2.dat. Layout after the reference's per-32-byte
    endianness flip + arkworks LE deserialize: the raw file is
    BE(x.c0) || BE(x.c1) || BE(y.c0) || BE(y.c1)."""
    with open(path, "rb") as fh:
        data = fh.read(128)
    if len(data) < 128:
        raise ValueError("g2.dat too small")
    xc0 = int.from_bytes(data[0:32], "big")
    xc1 = int.from_bytes(data[32:64], "big")
    yc0 = int.from_bytes(data[64:96], "big")
    yc1 = int.from_bytes(data[96:128], "big")
    return ((xc0, xc1), (yc0, yc1))


def write_g2_dat(path: str, pt) -> None:
    (xc0, xc1), (yc0, yc1) = pt
    with open(path, "wb") as fh:
        for v in (xc0, xc1, yc0, yc1):
            fh.write(int(v).to_bytes(32, "big"))


class ProverCrs:
    """G1 monomials as host affine points; `points`, when set, holds them
    once as Jacobian tensors (Z in {0, 1}) on a device."""

    def __init__(self, monomials: list, points=None):
        self.monomials = monomials
        self.points = points

    def __len__(self):
        return len(self.monomials)

    @property
    def device(self):
        """The device of the monomial tensors; None for a host CRS."""
        return None if self.points is None else self.points[0].device

    def _with_points(self, points):
        return ProverCrs(self.monomials, points)

    def to(self, device) -> "ProverCrs":
        """The same CRS with its monomials on `device`."""
        device = resolve_device(device)
        if self.device == device:
            return self
        if self.points is not None:
            return self._with_points(tuple(x.to(device) for x in self.points))
        return self._with_points(
            ec.encode_points(curves.BN254_G1, self.monomials, device=device))


class Crs(ProverCrs):
    def __init__(self, monomials: list, g2_x, points=None):
        super().__init__(monomials, points)
        self.g2_x = g2_x

    def _with_points(self, points):
        return Crs(self.monomials, self.g2_x, points)


def _fixed_base_table(curve, base, window=4):
    """Precompute per-window multiples of `base` for 254-bit scalars."""
    nwin = (256 + window - 1) // window
    table = []
    cur = curve.lift_affine(base)
    for _ in range(nwin):
        row = [None]
        acc = None
        for _ in range((1 << window) - 1):
            acc = curve.add(acc, cur)
            row.append(acc)
        table.append(row)
        for _ in range(window):
            cur = curve.double(cur)
    return table


def _fixed_base_mul(curve, table, k, window=4):
    acc = None
    i = 0
    while k:
        d = k & ((1 << window) - 1)
        if d:
            acc = curve.add(acc, table[i][d])
        k >>= window
        i += 1
    return acc


_LOCAL_TAU = 0x1337C0DE  # fixed, public: local testing CRS only — NOT secure


def local_crs(n: int, tau: int | None = None, device=None) -> Crs:
    """Self-consistent CRS with known tau: monomials tau^i*G1, g2_x=tau*G2.

    For testing / self-verification only (the trapdoor is public). With no
    `device`: ~n fixed-base scalar muls on the host curve, a host CRS. With
    a `device`: tau^i on the host, then the n products tau^i * G1 as one
    batched double-and-add over n lanes on the device, normalised to affine
    there; the CRS keeps those points on the device and their host affine
    ints (equal to the host construction's) as `monomials`."""
    g2 = host_curve(curves.BN254_G2)
    r = curves.BN254_G1.scalar_field.p
    tau = _LOCAL_TAU if tau is None else tau
    powers = []
    power = 1
    for _ in range(n):
        powers.append(power)
        power = power * tau % r
    g2_x = g2.affine_ints(
        g2.mul(g2.lift_affine(curves.BN254_G2.generator), tau))
    if device is not None:
        points = _device_powers(powers, resolve_device(device))
        return Crs(ec.decode_points(curves.BN254_G1, points), g2_x, points)
    g1 = host_curve(curves.BN254_G1)
    table = _fixed_base_table(g1, curves.BN254_G1.generator)
    pts = [g1.affine_ints(_fixed_base_mul(g1, table, k)) for k in powers]
    return Crs(pts, g2_x)


def _device_powers(powers: list[int], device):
    """[k_i] G1 for standard-form scalars k_i, as affine-or-infinity
    Jacobian tensors on `device` (one `scalar_mul` over all lanes)."""
    spec = curves.BN254_G1
    fr = spec.scalar_field
    scalars = torch.as_tensor(
        ints_to_limbs(powers, fr.nlimbs).astype(np.int64), device=device)
    gen = ec.encode_points(spec, [spec.generator], device=device)
    lanes = tuple(x.expand((len(powers),) + x.shape[1:]).contiguous()
                  for x in gen)
    return ec.to_affine(spec, ec.scalar_mul(spec, lanes, scalars))


_CRS_CACHE: dict[int, Crs] = {}


def cached_local_crs(n: int) -> Crs:
    """Power-of-two-sized local CRS, memoized across tests in-process and
    on disk (Barretenberg .dat format — doubles as a write_g1_dat test)."""
    size = 1
    while size < n:
        size *= 2
    if size not in _CRS_CACHE:
        cache_dir = cache_home("crs")
        g1p = os.path.join(cache_dir, f"local_bn254_g1_{size}.dat")
        g2p = os.path.join(cache_dir, f"local_bn254_g2_{size}.dat")
        if os.path.exists(g1p) and os.path.exists(g2p):
            crs = Crs(read_g1_dat(g1p, size), read_g2_dat(g2p))
            _check_local_crs(crs)
            _CRS_CACHE[size] = crs
        else:
            crs = local_crs(size)
            write_g1_dat(g1p, crs.monomials)
            write_g2_dat(g2p, crs.g2_x)
            _CRS_CACHE[size] = crs
    return _CRS_CACHE[size]


def cache_home(sub: str) -> str:
    """User-scoped cache directory (mode 0700): a fixed world-writable
    /tmp path would let another local user pre-seed poisoned artifacts
    that silently change what prove/verify compute."""
    root = os.environ.get("COSNARKS_CACHE",
                          os.path.join(os.path.expanduser("~"),
                                       ".cache", "cosnarks"))
    path = os.path.join(root, sub)
    os.makedirs(path, mode=0o700, exist_ok=True)
    try:
        os.chmod(root, 0o700)
    except OSError:  # pragma: no cover - root may be ~/.cache itself
        pass
    return path


def _check_local_crs(crs: Crs) -> None:
    """Integrity check for cache loads: the known-tau structure must hold
    (monomials[0] = G1, monomials[i+1] = tau*monomials[i], g2_x = tau*G2).
    Catches a corrupted or tampered cache file before it reaches
    prove/verify. A size-1 CRS (the download-crs default) legitimately has
    no monomials[1]; only the structure that exists is checked. Beyond the
    head, the LAST monomial pair is tau-consistency-checked so tail
    corruption of a long cache file is caught too."""
    g1 = host_curve(curves.BN254_G1)
    g2 = host_curve(curves.BN254_G2)

    def tau_next(pt):
        return g1.affine_ints(
            _fixed_base_mul(g1, _fixed_base_table(g1, pt), _LOCAL_TAU))

    ok = (len(crs.monomials) >= 1
          and crs.monomials[0] == curves.BN254_G1.generator
          and crs.g2_x == g2.affine_ints(
              g2.mul(g2.lift_affine(curves.BN254_G2.generator), _LOCAL_TAU)))
    if ok and len(crs.monomials) >= 2:
        ok = (crs.monomials[1] == tau_next(crs.monomials[0])
              and crs.monomials[-1] == tau_next(crs.monomials[-2]))
    if not ok:
        raise ValueError(
            "cached local CRS failed its integrity check (delete the "
            "COSNARKS_CACHE crs directory and regenerate)")
