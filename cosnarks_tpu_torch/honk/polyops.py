"""Polynomial helpers over BN254 Fr: PyTorch port of
cosnarks_tpu.honk.polyops.

Two halves:

- host scalar helpers on short lists of python ints, copied unchanged:
  `eval_poly`, `extend_univariate`, `evaluate_univariate`,
  `batch_invert_ints` (the JAX package's `batch_invert`) and the host
  Pippenger `_host_pippenger`;
- tensor versions of the vector work, on (k, 16) int64 Montgomery limb
  tensors on any device: `shifted`, `add_scaled`, `evaluate_mle` (a fold
  in halves), `batch_invert` (a prefix product, one inversion, a suffix
  pass), `factor_roots` (two products and a suffix sum), `evaluate_t`
  and `sum_rows`. Every product goes through `mont.mul` (K1 on the card);
  prefix products and suffix sums are the log-depth doubling scan of
  `plonk.prove`.

`commit` takes its route from the CRS: `msm()` over the CRS's device
points when it has them (K1, K3, K4 on the card; the kernels' plain
versions for CPU points), `_host_pippenger` for a host CRS. A coefficient
tensor must lie on the CRS's device, a host CRS counting as the CPU
(`check_crs_device`): no commitment moves its work to another device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..ec import curve as ec
from ..ec import curves
from ..ec import msm as msm_mod
from ..ec.host import host_curve
from ..ff import mont
from ..ff.bigint import ints_to_limbs, limbs_to_ints
from ..ff.spec import BN254_FR
from ..plonk.prove import _powers_mont, scan
from ..utils import timing

FR = BN254_FR
R = BN254_FR.p
NLIMBS = FR.nlimbs


# -- host scalar helpers (copied) -------------------------------------------

def batch_invert_ints(vals: list[int], p: int = R) -> list[int]:
    """Montgomery batch inversion; zeros stay zero (utils.rs)."""
    n = len(vals)
    out = [0] * n
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * (v if v else 1) % p
    inv = pow(prefix[n], -1, p)
    for i in range(n - 1, -1, -1):
        if vals[i]:
            out[i] = prefix[i] * inv % p
            inv = inv * vals[i] % p
    return out


def eval_poly(coeffs: list[int], x: int, p: int = R) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


_EXT_CACHE: dict[tuple[int, int], tuple] = {}


def _extension_consts(length: int, target: int, p: int = R):
    key = (length, target)
    if key not in _EXT_CACHE:
        # denominators d_i = prod_{j != i} (x_i - x_j) over 0..length-1
        denoms = []
        for i in range(length):
            d = 1
            for j in range(length):
                if j != i:
                    d = d * (i - j) % p
            denoms.append(d)
        dinv = batch_invert_ints(denoms, p)
        # for each target point k in length..target-1:
        #   B(k) = prod_j (k - j); terms_i = B(k) / (d_i * (k - x_i))
        rows = []
        for k in range(length, target):
            bk = 1
            for j in range(length):
                bk = bk * (k - j) % p
            row = [bk * dinv[i] % p * pow(k - i, -1, p) % p
                   for i in range(length)]
            rows.append(row)
        _EXT_CACHE[key] = tuple(tuple(r) for r in rows)
    return _EXT_CACHE[key]


def extend_univariate(evals: list[int], target: int, p: int = R) -> list[int]:
    """Evaluations at 0..len-1 -> evaluations at 0..target-1
    (univariate.rs extend_from)."""
    length = len(evals)
    if length >= target:
        return list(evals[:target])
    rows = _extension_consts(length, target, p)
    out = list(evals)
    for row in rows:
        out.append(sum(e * c for e, c in zip(evals, row)) % p)
    return out


def evaluate_univariate(evals: list[int], u: int, p: int = R) -> int:
    """Evaluate a univariate given by evaluations at 0..len-1 at point u
    (univariate.rs evaluate)."""
    length = len(evals)
    u %= p
    if u < length:
        return evals[u]
    numer = 1
    for i in range(length):
        numer = numer * (u - i) % p
    denoms = []
    for i in range(length):
        d = 1
        for j in range(length):
            if j != i:
                d = d * (i - j) % p
        denoms.append(d * (u - i) % p)
    dinv = batch_invert_ints(denoms, p)
    acc = 0
    for e, d in zip(evals, dinv):
        acc = (acc + e * d) % p
    return acc * numer % p


# -- host <-> device --------------------------------------------------------

def encode(values, device=None) -> torch.Tensor:
    """Python ints -> (k, 16) Montgomery limbs on `device`: standard-form
    limbs from one byte string, then one `to_mont` on the device. The copy
    from pageable host memory is a host-blocking point (`honk.encode`)."""
    dev = resolve_device(device)
    std = ints_to_limbs([int(v) % R for v in values], NLIMBS)
    with timing.blocking("honk.encode"):
        t = torch.as_tensor(std.astype(np.int64), device=dev)
    return mont.to_mont(FR, t)


def decode(t: torch.Tensor, site: str = "honk.decode") -> list[int]:
    """(k, 16) Montgomery limbs -> python ints (one `from_mont` on the
    tensor's device, then one copy to the host, a host-blocking point
    counted under `site`)."""
    std = mont.from_mont(FR, t)
    with timing.blocking(site):
        host = std.cpu().numpy()
    return limbs_to_ints(host)


@functools.lru_cache(maxsize=None)
def _const(value: int, device: torch.device) -> torch.Tensor:
    return mont.constant(FR, value, (1,), device=device)


def const(value: int, device) -> torch.Tensor:
    """A python int as a (1, 16) Montgomery constant, encoded once per
    device and value."""
    return _const(int(value) % R, torch.device(device))


def zeros(k: int, device) -> torch.Tensor:
    return mont.zeros(FR, (k,), device=device)


def powers(x: int, k: int, device) -> torch.Tensor:
    """[1, x, ..., x^(k-1)] as (k, 16) limbs, made on the device."""
    return _powers_mont(FR, x % R, k, device)


# -- tensor versions of the vector work -------------------------------------

def add(a, b):
    return mont.add(FR, a, b)


def sub(a, b):
    return mont.sub(FR, a, b)


def mul(a, b):
    return mont.mul(FR, a, b)


def scale(t, scalar: int):
    """t * scalar for a python-int scalar."""
    return mont.mul(FR, t, const(scalar, t.device))


def sum_rows(t) -> torch.Tensor:
    """Sum over axis 0: (k, ..., 16) -> (..., 16), a log-depth tree."""
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        s = add(t[:half], t[half:2 * half])
        t = torch.cat([s, t[2 * half:]]) if t.shape[0] % 2 else s
    return t[0]


def shifted(t) -> torch.Tensor:
    """Coefficients moved down by one row, a zero row appended
    (polynomial.rs shifted)."""
    return torch.cat([t[1:], zeros(1, t.device)])


def add_scaled(dst, src, scalar: int) -> torch.Tensor:
    """dst + scalar * src over src's rows (src no longer than dst); a new
    tensor."""
    k = src.shape[0]
    head = add(dst[:k], scale(src, scalar))
    return torch.cat([head, dst[k:]]) if k < dst.shape[0] else head


def fold(t, u: int) -> torch.Tensor:
    """Partial evaluation in the lowest variable: out[i] = t[2i] +
    u * (t[2i+1] - t[2i]), over the leading axis of length 2m."""
    even, odd = t[0::2], t[1::2]
    return add(even, scale(sub(odd, even), u))


def evaluate_mle(t, points: list[int]) -> int:
    """Multilinear evaluation: t holds the evaluations over the hypercube,
    folded in halves once per point."""
    assert t.shape[0] == 1 << len(points)
    for u in points:
        t = fold(t, u)
    return decode(t)[0]


def evaluate_t(t, x: int) -> torch.Tensor:
    """sum_i t_i x^i as a (1, 16) tensor: one product with the powers of x
    and a tree sum."""
    return sum_rows(mul(t, powers(x, t.shape[0], t.device)))[None]


def _is_zero(t):
    return (t == 0).all(-1)


def batch_invert(t) -> torch.Tensor:
    """Batch inversion with zeros kept zero: inclusive prefix products and
    suffix products (doubling scans), one inversion of the total on the
    host, and out_i = prefix_(i-1) * suffix_(i+1) / total."""
    k = t.shape[0]
    dev = t.device
    zero = _is_zero(t)
    one = const(1, dev).expand(k, NLIMBS)
    safe = torch.where(zero[:, None], one, t)

    def mul_op(a, b):
        return mul(a, b)

    prefix = scan(mul_op, safe)
    suffix = scan(mul_op, safe, reverse=True)
    total = decode(prefix[-1:], "honk.batch_invert")[0]
    total_inv = const(pow(total, -1, R), dev)
    before = torch.cat([const(1, dev), prefix[:-1]])
    after = torch.cat([suffix[1:], const(1, dev)])
    out = mul(mul(before, after), total_inv.expand(k, NLIMBS))
    return torch.where(zero[:, None], torch.zeros_like(out), out)


def factor_roots(t, root: int) -> torch.Tensor:
    """Divide p(X) by (X - root) for p(root) = 0, as the prover always has
    it (polynomial.rs:183): q_i = root^-(i+1) * sum_{j>i} a_j root^j, two
    products and a suffix sum."""
    root %= R
    k = t.shape[0]
    if root == 0 or k < 2:
        return t[1:]
    dev = t.device
    terms = mul(t, powers(root, k, dev))
    suffix = scan(add, terms, reverse=True)
    inv_pows = powers(pow(root, -1, R), k, dev)
    return mul(suffix[1:], inv_pows[1:])


# -- KZG commitments --------------------------------------------------------

def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        cur = torch.cuda.current_device
        return (cur() if a.index is None else a.index) == \
            (cur() if b.index is None else b.index)
    return a.index == b.index or None in (a.index, b.index)


def check_crs_device(crs, device) -> None:
    """Raise unless the CRS's points lie on `device`, a host CRS counting
    as the CPU: a CUDA key or coefficients never meet a host CRS (whose
    Pippenger runs on the host), and card coefficients never go to points
    on the CPU."""
    have = crs.device if crs.device is not None else torch.device("cpu")
    if not _same_device(have, device):
        kind = "host" if crs.device is None else str(crs.device)
        raise ValueError(
            f"CRS on {kind} cannot commit to coefficients on "
            f"{torch.device(device)}: put the CRS there with crs.to(device)")


def commit(coeffs, crs) -> tuple | None:
    """MSM of coeffs over crs.monomials (utils.rs Utils::commit); returns
    an affine (x, y) int pair or None for the identity. `coeffs` is a
    (k, 16) Montgomery limb tensor on the CRS's device (the CPU for a host
    CRS) or a list of python ints. A CRS with device points runs `msm()`
    there; a host CRS the host Pippenger."""
    n = len(coeffs)
    if n > len(crs.monomials):
        raise ValueError("CRS too small")
    if isinstance(coeffs, torch.Tensor):
        check_crs_device(crs, coeffs.device)
    if crs.points is not None:
        return commit_msm(coeffs, crs)
    ints = decode(coeffs) if isinstance(coeffs, torch.Tensor) else coeffs
    idx = [i for i, c in enumerate(ints) if c % R]
    if not idx:
        return None
    return _host_pippenger([crs.monomials[i] for i in idx],
                           [ints[i] % R for i in idx])


def commit_msm(coeffs, crs) -> tuple | None:
    """`msm()` of the coefficients (standard form) over the CRS's first
    len(coeffs) device points. A tensor must lie on the CRS's device; a
    list is encoded there."""
    if crs.points is None:
        raise ValueError("commit_msm needs a CRS with device points")
    if isinstance(coeffs, torch.Tensor):
        check_crs_device(crs, coeffs.device)
        t = coeffs
    else:
        t = encode(coeffs, crs.device)
    k = t.shape[0]
    pts = tuple(x[:k] for x in crs.points)
    acc = msm_mod.msm(curves.BN254_G1, pts, mont.from_mont(FR, t))
    return ec.decode_points(curves.BN254_G1, tuple(x[None] for x in acc),
                            site="honk.commit_decode")[0]


def _host_pippenger(pts: list, scalars: list[int], c: int = 6):
    """Windowed bucket MSM on the host curve (affine adds)."""
    g1 = host_curve(curves.BN254_G1)
    lifted = [g1.lift_affine(pt) for pt in pts]
    nbits = max(s.bit_length() for s in scalars)
    nwin = (nbits + c - 1) // c or 1
    acc = None
    for w in range(nwin - 1, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = g1.double(acc)
        buckets = [None] * (1 << c)
        for pt, s in zip(lifted, scalars):
            d = (s >> (w * c)) & ((1 << c) - 1)
            if d:
                buckets[d] = g1.add(buckets[d], pt)
        run = None
        tot = None
        for b in range((1 << c) - 1, 0, -1):
            run = g1.add(run, buckets[b])
            tot = g1.add(tot, run)
        acc = g1.add(acc, tot)
    return g1.affine_ints(acc) if acc is not None else None
