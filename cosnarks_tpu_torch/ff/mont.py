"""Montgomery arithmetic on 16-bit limb tensors (int64), PyTorch port of
cosnarks_tpu.ff.mont.

Field elements are (..., nlimbs) little-endian 16-bit limbs in int64 tensors
(torch has no add, shift or compare on uint32), kept in Montgomery form with
R = 2**(16*nlimbs) and always canonical (< p). Every public op returns the
canonical representative, so its limbs equal the JAX package's bit for bit.

``mul`` (and everything built on it: sqr, to/from_mont, pow_static, inv)
goes through the K1 wrapper in :mod:`.mont_kernel`, which launches the CUDA
kernel for CUDA tensors and takes its plain version for CPU tensors. Every
CUDA mul launches K1: there is no batch threshold as on the TPU.

add / sub / neg stay plain torch ops (the JAX package leaves them to XLA).
They form the candidates (s - p, s) or (d, d + p) and normalise the carries
exactly (:func:`carry`); the candidate in [0, p) is the canonical result.

``reduce_columns`` mirrors the JAX version step for step, including the
carry its Montgomery step drops when the represented value is >= p*R
(random draws feed it such values; proofs stay equal only if the port
drops the same carry).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..utils import timing
from .bigint import LIMB_BITS, LIMB_MASK, int_to_limbs, ints_to_limbs, limbs_to_ints
from .spec import Field

MASK = LIMB_MASK
U32_MASK = 0xFFFFFFFF
I64 = torch.int64


@functools.lru_cache(maxsize=None)
def _host_consts(field: Field) -> dict:
    n = field.nlimbs
    rinv = pow(1 << (LIMB_BITS * n), -1, field.p)
    # fold[k] = limbs of 2^(16k) * R^-1 mod p: sum_k T_k fold[k] = T R^-1
    fold = ints_to_limbs(
        [(pow(2, LIMB_BITS * k, field.p) * rinv) % field.p
         for k in range(2 * n - 1)], n).astype(np.int64)
    # fold2[i, l] = fold[i + l], so the outer product a_i b_l folds in one
    # go; kept as its low and high bytes in float64, two exact matmuls
    idx = np.arange(n)[:, None] + np.arange(n)[None, :]
    fold2 = fold[idx].reshape(n * n, n)
    qweights = np.array(
        [float(1 << (LIMB_BITS * j)) / float(field.p) for j in range(n)],
        dtype=np.float64)
    p_wide = np.append(field.p_limbs.astype(np.int64), 0)
    return {
        "p": field.p_limbs.astype(np.int64),
        # offsets of the canonical-value candidates (n+1 limbs)
        "add_offsets": np.stack([-p_wide, 0 * p_wide]),
        "sub_offsets": np.stack([0 * p_wide, p_wide]),
        "mul_offsets": np.stack([-p_wide, 0 * p_wide, p_wide]),
        "one_mont": field.one_mont.astype(np.int64),
        "r2": field.r2_limbs.astype(np.int64),
        "one_std": int_to_limbs(1, n).astype(np.int64),
        "fold": fold,
        "fold2_lo": (fold2 & 0xFF).astype(np.float64),
        "fold2_hi": (fold2 >> 8).astype(np.float64),
        "qweights": qweights,
    }


@functools.lru_cache(maxsize=None)
def consts(field: Field, device: torch.device) -> dict:
    """Field constants as tensors on `device` (cached per device)."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in _host_consts(field).items()}


# --------------------------------------------------------------------------
# exact carry normalisation
# --------------------------------------------------------------------------

SIGN = 1 << (LIMB_BITS - 1)


def _pass(t):
    hi = t >> LIMB_BITS
    return (t & MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))


def carry(t: torch.Tensor, passes: int = 0) -> torch.Tensor:
    """Exact carry normalisation of signed limbs to two's complement over
    t's width (value mod 2^(16*width)): every limb ends in [0, 2^16), and a
    value whose magnitude fits in width-1 limbs is negative iff its top limb
    is >= 2^15. `passes` unconditional passes run first (enough to bring
    known-large columns down to carries of -1, 0, 1); then passes repeat
    until no carry is left."""
    for _ in range(passes):
        t = _pass(t)
    while True:
        hi = (t >> LIMB_BITS)[..., :-1]
        with timing.blocking("mont.carry"):
            done = not bool(hi.any())
        if done:
            return t & MASK
        t = (t & MASK) + torch.nn.functional.pad(hi, (1, 0))


def pick_canonical(cands: torch.Tensor) -> torch.Tensor:
    """cands (k, ..., n+1), normalised by :func:`carry`, in increasing value
    steps of p: the low n limbs of the first candidate whose value is >= 0
    (exactly one of them lies in [0, p))."""
    neg = cands[..., -1] >= SIGN  # (k, ...)
    out = cands[-1]
    for i in range(cands.shape[0] - 2, -1, -1):
        out = torch.where(neg[i].unsqueeze(-1), out, cands[i])
    return out[..., :-1]


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns: (..., n) x (..., n) -> (..., 2n-1),
    column k = sum_i a_i b_(k-i), computed as one outer product summed along
    its antidiagonals (skewed view of the zero-padded rows)."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., n, n)
    padded = torch.nn.functional.pad(prod, (0, n))  # (..., n, 2n)
    flat = padded.reshape(lead + (2 * n * n,))
    skew = flat[..., : n * (2 * n - 1)].reshape(lead + (n, 2 * n - 1))
    return skew.sum(-2)


def _folded_product(c: dict, a, b):
    """n columns whose value is congruent to a*b*R^-1 (each < n^2 2^48).
    On the CPU the outer product folds by two float64 matmuls, one per
    byte of the fold constants: each sum of n^2 terms < 2^32 * 2^8 stays
    below 2^53, so both are exact, and the columns are lo + 256 * hi (an
    int64 matmul has no BLAS and is tens of times slower). On the card the
    product columns are folded with a broadcast multiply-sum instead (same
    integers)."""
    if a.device.type == "cpu":
        n = a.shape[-1]
        outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(
            a.shape[:-1] + (n * n,)).to(torch.float64)
        lo = (outer @ c["fold2_lo"]).to(I64)
        hi = (outer @ c["fold2_hi"]).to(I64)
        return lo + (hi << 8)
    return (conv(a, b).unsqueeze(-1) * c["fold"]).sum(-2)


def mul_plain(field: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p, canonical, in plain int64 torch ops (K1's plain
    version; a and b of one shape).

    The schoolbook product is folded to n columns with the constants
    2^(16k) R^-1 mod p (sums < 2^56 for n = 16), a float64 estimate of the
    quotient by p (off by at most one) is taken off, and the canonical value
    is the first non-negative of the three candidates V - p, V, V + p."""
    c = consts(field, a.device)
    r = _folded_product(c, a, b)
    q = torch.floor(r.to(torch.float64) @ c["qweights"]).to(I64)
    v = torch.nn.functional.pad(r - q.unsqueeze(-1) * c["p"], (0, 1))
    return pick_canonical(carry(v + _offsets(c["mul_offsets"], v), passes=4))


def _offsets(offs, x):
    """(k, n+1) candidate offsets shaped to broadcast against x (..., n+1)
    into (k, ..., n+1)."""
    return offs.view((offs.shape[0],) + (1,) * (x.dim() - 1) + (-1,))


# --------------------------------------------------------------------------
# public ops — all inputs/outputs canonical Montgomery-form limb tensors
# --------------------------------------------------------------------------

def mul(field: Field, a, b):
    """Montgomery product a*b*R^-1 mod p (broadcasting), through K1."""
    from . import mont_kernel

    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return mont_kernel.mul(field, a.contiguous(), b.contiguous())


def sqr(field: Field, a):
    return mul(field, a, a)


def add(field: Field, a, b):
    s = torch.nn.functional.pad(a + b, (0, 1))
    offs = consts(field, s.device)["add_offsets"]  # s - p, s
    return pick_canonical(carry(s + _offsets(offs, s), passes=1))


def sub(field: Field, a, b):
    d = torch.nn.functional.pad(a - b, (0, 1))
    offs = consts(field, d.device)["sub_offsets"]  # d, d + p
    return pick_canonical(carry(d + _offsets(offs, d), passes=1))


def neg(field: Field, a):
    return sub(field, torch.zeros_like(a), a)


def double(field: Field, a):
    return add(field, a, a)


def from_mont(field: Field, a):
    """Montgomery form -> standard form (a * R^-1 mod p)."""
    one = consts(field, a.device)["one_std"]
    return mul(field, a, one)


def to_mont(field: Field, a):
    """Standard form -> Montgomery form."""
    return mul(field, a, consts(field, a.device)["r2"])


def _propagate(cols, out_len: int):
    """Carry-propagate columns (< 2^32 each) to `out_len` 16-bit limbs,
    dropping what does not fit (the JAX package's _propagate)."""
    lo = cols & MASK
    hi = cols >> LIMB_BITS
    t = _pad_to(lo, out_len)[..., :out_len]
    hi_shift = _pad_to(torch.cat([torch.zeros_like(hi[..., :1]), hi], -1),
                       out_len)[..., :out_len]
    t = t + hi_shift
    out = torch.empty_like(t)
    c = torch.zeros_like(t[..., 0])
    for k in range(out_len):
        s = t[..., k] + c
        out[..., k] = s & MASK
        c = s >> LIMB_BITS
    return out


def _pad_to(x, length: int):
    deficit = length - x.shape[-1]
    if deficit <= 0:
        return x
    return torch.nn.functional.pad(x, (0, deficit))


def _cond_sub_p(field: Field, t):
    """t (value < 2p) -> t mod p, via one borrow chain."""
    p = consts(field, t.device)["mul_offsets"][0]  # -p
    d = carry(torch.nn.functional.pad(t, (0, 1)) + p)
    return torch.where((d[..., -1] >= SIGN)[..., None], t, d[..., :-1])


def _mont_reduce_columns(field: Field, cols):
    """Montgomery-reduce 2n columns -> V*R^-1 mod p, as the JAX package's
    _mont_reduce_columns does it: uint32 column arithmetic (emulated with
    a 32-bit mask), n CIOS steps, then a carry propagation into n limbs
    that DROPS the carry out of the top limb. Correct only for V < p*R;
    kept exactly so, because random draws depend on it."""
    c = consts(field, cols.device)
    n = field.nlimbs
    p = c["p"]
    n0inv = field.n0inv
    t = (cols & U32_MASK).clone()
    for i in range(n):
        m = (t[..., i] * n0inv) & MASK
        mp = m.unsqueeze(-1) * p
        seg = t[..., i:i + n + 1]
        seg[..., :n] += mp & MASK
        seg[..., 1:] += mp >> LIMB_BITS
        seg &= U32_MASK
        # seg[0] = 0 mod 2^16 by construction; fold its carry into seg[1]
        carry0 = seg[..., 0] >> LIMB_BITS
        seg[..., 0] &= MASK
        seg[..., 1] = (seg[..., 1] + carry0) & U32_MASK
    t = _propagate(t[..., n:], n)
    return _cond_sub_p(field, t)


def reduce_columns(field: Field, cols):
    """Reduce accumulated columns (each < 2**32, any length <= 2n-2) mod p,
    staying in the same (Montgomery) domain as the summands."""
    n = field.nlimbs
    m = cols.shape[-1]
    t = _propagate(cols & U32_MASK, min(m + 2, 2 * n))
    v = _mont_reduce_columns(field, _pad_to(t, 2 * n))
    return to_mont(field, v)


def pow_static(field: Field, a, e: int):
    """a**e (Montgomery in/out) for a python-int exponent, square and
    multiply from the top bit."""
    acc = broadcast_one(field, a.shape[:-1], device=a.device).clone()
    for bit in bin(e)[2:] if e else "":
        acc = sqr(field, acc)
        if bit == "1":
            acc = mul(field, acc, a)
    return acc


def inv(field: Field, a):
    """Batched modular inverse via Fermat (a^(p-2)); inv(0) = 0."""
    return pow_static(field, a, field.p - 2)


def is_zero(field: Field, a):
    return (a == 0).all(-1)


def eq(field: Field, a, b):
    return (a == b).all(-1)


def select(mask, a, b):
    """where(mask, a, b) with mask broadcast over the limb axis."""
    return torch.where(mask[..., None], a, b)


def zeros(field: Field, shape=(), device=None):
    return torch.zeros(tuple(shape) + (field.nlimbs,), dtype=I64,
                       device=resolve_device(device))


def broadcast_one(field: Field, shape=(), device=None):
    one = consts(field, resolve_device(device))["one_mont"]
    return one.expand(tuple(shape) + (field.nlimbs,))


def constant(field: Field, value: int, shape=(), device=None):
    """Embed a python int as a (broadcast) Montgomery-form constant."""
    m = field.to_mont_int(value % field.p)
    with timing.blocking("mont.constant"):
        limbs = torch.as_tensor(
            int_to_limbs(m, field.nlimbs).astype(np.int64),
            device=resolve_device(device))
    return limbs.expand(tuple(shape) + (field.nlimbs,))


# --------------------------------------------------------------------------
# host conversions
# --------------------------------------------------------------------------

def encode(field: Field, values, mont: bool = True, device=None):
    """List of python ints -> limb tensor (Montgomery form by default)."""
    vals = [v % field.p for v in values]
    if mont:
        vals = [field.to_mont_int(v) for v in vals]
    arr = ints_to_limbs(vals, field.nlimbs).astype(np.int64)
    with timing.blocking("mont.encode"):
        return torch.as_tensor(arr, device=resolve_device(device))


def decode(field: Field, arr, mont: bool = True,
           site: str = "mont.decode") -> list[int]:
    """Limb tensor -> python ints (converting out of Montgomery form). The
    copy to the host is a host-blocking point, counted under `site`."""
    with timing.blocking(site):
        host = arr.detach().cpu().numpy()
    ints = limbs_to_ints(host)
    if mont:
        ints = [field.from_mont_int(v) for v in ints]
    return ints
