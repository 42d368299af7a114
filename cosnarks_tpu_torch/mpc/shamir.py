"""Shamir secret sharing (n parties, threshold t, 2t+1 <= n) over prime
fields and EC groups: PyTorch port of cosnarks_tpu.mpc.shamir.

DN07-style preprocessed double-share pairs (r_t, r_2t) via Vandermonde
extraction, king-based degree reduction for multiplication, interpolation
opens (in the exponent for points). Simplifications the JAX package makes
too, correctness-preserving:
 - pair generation uses explicit all-to-all contribution sharing;
 - the king reshares with a fresh uniform degree-t polynomial for all n
   parties.

Shares are single limb tensors (the polynomial evaluated at alpha_i = id+1);
a degree-t share is also a valid degree-2t share, so Groth16 "half shares"
are share values. Every random draw (ChaCha `draw_field`, host
`random.Random`) is the JAX package's, in the same order, so shares agree
bit for bit. Tensors live on the state's device; nothing here updates a
tensor that may have been sent (see mpc/net/local.py).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..ec import curve as ec
from ..ff import mont
from ..ff.spec import Field
from . import chacha
from .rng import LABEL_FIELD, draw_field

KING = 0


# -- host lagrange/vandermonde helpers --------------------------------------

def lagrange_at_zero(field: Field, party_ids: list[int]) -> list[int]:
    """Interpolation coefficients at 0 for points alpha_i = id+1."""
    p = field.p
    out = []
    xs = [i + 1 for i in party_ids]
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i != j:
                num = num * xj % p
                den = den * (xj - xi) % p
        out.append(num * pow(den, -1, p) % p)
    return out


def share_values(field: Field, values: list[int], n: int, t: int, rng,
                 device=None) -> list:
    """Host split: per-party (k, nlimbs) Montgomery limb tensors."""
    shares = [[] for _ in range(n)]
    p = field.p
    for v in values:
        coeffs = [v] + [rng.randrange(p) for _ in range(t)]
        for i in range(n):
            x = i + 1
            acc, xp = 0, 1
            for c in coeffs:
                acc = (acc + c * xp) % p
                xp = xp * x % p
            shares[i].append(acc)
    return [mont.encode(field, s, device=device) for s in shares]


def combine_values(field: Field, shares, party_ids: list[int]) -> list[int]:
    """Host recombine from len(party_ids) share tensors (>= t+1 of them)."""
    return mont.decode(field, interpolate(field, shares, party_ids))


# -- state ------------------------------------------------------------------

@dataclasses.dataclass
class ShamirState:
    id: int
    n: int
    t: int
    key_bytes: bytes  # private 256-bit ChaCha key (this party only)
    key: torch.Tensor  # derived words, on the state's device
    r_t: torch.Tensor  # buffered pair shares (B, nlimbs)
    r_2t: torch.Tensor
    pos: int = 0
    batch: int = 64  # refill granularity
    _ctr: int = 0
    _forks: int = 0

    @classmethod
    def setup(cls, net, field: Field, t: int, pairs: int = 64,
              seed: bytes | None = None, device=None) -> "ShamirState":
        import os

        n = net.n_parties
        if 2 * t + 1 > n:
            raise ValueError("threshold too large")
        if seed is None:
            seed = os.urandom(32)
        device = resolve_device(device)
        # domain-separate per party so a shared test seed still yields
        # private per-party randomness
        key_bytes = chacha.derive_key(seed.ljust(32, b"\0")[:32],
                                      b"shamir" + bytes([net.id]))
        st = cls(net.id, n, t, key_bytes,
                 torch.as_tensor(chacha.key_to_words(key_bytes),
                                 device=device),
                 mont.zeros(field, (0,), device=device),
                 mont.zeros(field, (0,), device=device),
                 batch=max(pairs, 1))
        st.refill_pairs(field, net, pairs)
        return st

    @property
    def device(self) -> torch.device:
        return self.key.device

    def _draw(self, field: Field, shape):
        self._ctr += 1
        return draw_field(self.key, LABEL_FIELD, self._ctr, field, shape)

    def refill_pairs(self, field: Field, net, count: int):
        """DN07 double-share generation: every party shares a batch of random
        values at degrees t and 2t; a Vandermonde matrix turns the n
        contributions into t+1 uniformly random pairs per batch row."""
        n, t = self.n, self.t
        m = -(-count // (t + 1))
        my_c = self._draw(field, (m,))
        sh_t = self._share_batch(field, my_c, t, m)
        sh_2t = self._share_batch(field, my_c, 2 * t, m)
        for j in range(n):
            if j != self.id:
                net.send(j, (sh_t[j], sh_2t[j]))
        contrib_t = [None] * n
        contrib_2t = [None] * n
        contrib_t[self.id] = sh_t[self.id]
        contrib_2t[self.id] = sh_2t[self.id]
        for j in range(n):
            if j != self.id:
                contrib_t[j], contrib_2t[j] = net.recv(j)
        # Vandermonde extraction: pairs_k = sum_i (i+1)^k * contrib_i
        new_t, new_2t = [], []
        for k in range(t + 1):
            row = mont.encode(field, [pow(i + 1, k, field.p)
                                      for i in range(n)], device=self.device)
            rt = r2 = None
            for i in range(n):
                term_t = mont.mul(field, contrib_t[i], row[i])
                term_2 = mont.mul(field, contrib_2t[i], row[i])
                rt = term_t if rt is None else mont.add(field, rt, term_t)
                r2 = term_2 if r2 is None else mont.add(field, r2, term_2)
            new_t.append(rt)
            new_2t.append(r2)
        self.r_t = torch.cat([self.r_t[self.pos:]] + new_t)
        self.r_2t = torch.cat([self.r_2t[self.pos:]] + new_2t)
        self.pos = 0

    def _share_batch(self, field: Field, vals, deg: int, m: int):
        """Share (m,) values with degree-`deg` polys; returns per-party
        (m, nlimbs) tensors."""
        coeffs = [vals] + [self._draw(field, (m,)) for _ in range(deg)]
        out = []
        for j in range(self.n):
            pows = mont.encode(field, [pow(j + 1, k, field.p)
                                       for k in range(deg + 1)],
                               device=self.device)
            acc = None
            for k, c in enumerate(coeffs):
                term = mont.mul(field, c, pows[k])
                acc = term if acc is None else mont.add(field, acc, term)
            out.append(acc)
        return out

    def get_pairs(self, field: Field, k: int, net=None):
        """Consume k (r_t, r_2t) pairs, refilling on demand when a network
        is available."""
        deficit = self.pos + k - self.r_t.shape[0]
        if deficit > 0:
            if net is None:
                raise RuntimeError(
                    "correlated pair buffer exhausted and no network to "
                    "refill; provision more in setup")
            self.refill_pairs(field, net, max(deficit, self.batch))
        rt = self.r_t[self.pos:self.pos + k]
        r2 = self.r_2t[self.pos:self.pos + k]
        self.pos += k
        return rt, r2

    def fork(self) -> "ShamirState":
        """Independent child state: fresh derived key (fork-counter keyed so
        repeated forks differ) + half of the remaining pair buffer."""
        self._forks += 1
        child_key = chacha.derive_key(
            self.key_bytes, b"fork" + self._forks.to_bytes(8, "little"))
        remaining = self.r_t.shape[0] - self.pos
        half = remaining // 2
        child = ShamirState(
            self.id, self.n, self.t, child_key,
            torch.as_tensor(chacha.key_to_words(child_key),
                            device=self.device),
            self.r_t[self.pos + half:], self.r_2t[self.pos + half:],
            batch=self.batch)
        self.r_t = self.r_t[:self.pos + half]
        self.r_2t = self.r_2t[:self.pos + half]
        return child


# -- field ops --------------------------------------------------------------

def add(field, x, y):
    return mont.add(field, x, y)


def sub(field, x, y):
    return mont.sub(field, x, y)


def neg(field, x):
    return mont.neg(field, x)


def add_public(field, x, v):
    return mont.add(field, x, v)  # constant poly: every share shifts


def mul_public(field, x, v):
    return mont.mul(field, x, v)


def local_mul(field, x, y):
    """Share product: a valid degree-2t sharing of x*y."""
    return mont.mul(field, x, y)


_LAGRANGE: dict = {}


def _lagrange_tensor(field: Field, party_ids: list[int], device):
    """`lagrange_at_zero` as (len(party_ids), nlimbs) Montgomery limbs on
    `device`, encoded once per (field, ids, device)."""
    key = (field.name, tuple(party_ids), str(device))
    if key not in _LAGRANGE:
        _LAGRANGE[key] = mont.encode(field, lagrange_at_zero(field,
                                                             party_ids),
                                     device=device)
    return _LAGRANGE[key]


def interpolate(field: Field, shares: list, party_ids: list[int]):
    """Value at zero from the shares of `party_ids` (the first
    len(party_ids) of `shares`): the products with the Lagrange
    coefficients in one batched product, then summed."""
    first = shares[0]
    n = len(party_ids)
    lams = _lagrange_tensor(field, party_ids, first.device)
    terms = mont.mul(field, torch.stack(list(shares[:n])),
                     lams.reshape((n,) + (1,) * (first.dim() - 1)
                                  + (field.nlimbs,)))
    acc = terms[0]
    for term in terms[1:]:
        acc = mont.add(field, acc, term)
    return acc


def open(field: Field, x, net, state: ShamirState, degree: int | None = None):
    """Open a degree-`degree` sharing (default t): broadcast + interpolate
    from parties 0..degree."""
    d = state.t if degree is None else degree
    others = net.broadcast(x)
    ids = list(range(d + 1))
    shares = [x if i == state.id else others[i] for i in ids]
    return interpolate(field, shares, ids)


def degree_reduce(field: Field, vals, net, state: ShamirState):
    """Degree-2t sharing -> fresh degree-t sharing (king protocol).
    vals: (..., nlimbs)."""
    k = vals[..., 0].numel()
    flat = vals.reshape(k, field.nlimbs)
    r_t, r_2t = state.get_pairs(field, k, net)
    masked = mont.add(field, flat, r_2t)
    n, t = state.n, state.t
    if state.id == KING:
        lams = mont.encode(field, lagrange_at_zero(field,
                                                   list(range(2 * t + 1))),
                           device=state.device)
        acc = mont.mul(field, masked, lams[0])
        for i in range(1, 2 * t + 1):
            acc = mont.add(field, acc, mont.mul(field, net.recv(i), lams[i]))
        shares = state._share_batch(field, acc, t, k)
        for j in range(n):
            if j != KING:
                net.send(j, shares[j])
        fresh = shares[KING]
    else:
        if state.id <= 2 * t:
            net.send(KING, masked)
        fresh = net.recv(KING)
    return mont.sub(field, fresh, r_t).reshape(vals.shape)


def mul(field: Field, x, y, net, state: ShamirState):
    return degree_reduce(field, local_mul(field, x, y), net, state)


def rand(field: Field, state: ShamirState, shape=(), net=None):
    """Random degree-t share from the preprocessed buffer (burns a pair)."""
    k = 1
    for s in shape:
        k *= s
    r_t, _ = state.get_pairs(field, k, net)
    return r_t.reshape(tuple(shape) + (field.nlimbs,))


def promote_public(field: Field, v):
    return v  # constant polynomial: share = value on every party


# -- EC point shares --------------------------------------------------------

def _scalar_points(spec, pts, scalars_mont):
    std = mont.from_mont(spec.scalar_field, scalars_mont)
    return ec.scalar_mul(spec, pts, std)


def _generator(spec, device):
    return tuple(x[0] for x in ec.encode_points(spec, [spec.generator],
                                                device=device))


def point_interpolate(spec, pts: list, party_ids: list[int]):
    """Interpolation in the exponent: sum [lambda_i] P_i."""
    field = spec.scalar_field
    stacked = tuple(torch.stack([p[i] for p in pts]) for i in range(3))
    lams = mont.encode(field, lagrange_at_zero(field, party_ids),
                       device=stacked[0].device)
    scaled = _scalar_points(spec, stacked, lams)
    acc = tuple(x[0] for x in scaled)
    for i in range(1, len(pts)):
        acc = ec.add(spec, acc, tuple(x[i] for x in scaled))
    return acc


def open_point(spec, pt, net, state: ShamirState, degree: int | None = None):
    d = state.t if degree is None else degree
    others = net.broadcast(pt)
    ids = list(range(d + 1))
    pts = [pt if i == state.id else tuple(others[i]) for i in ids]
    return point_interpolate(spec, pts, ids)


def degree_reduce_point(spec, pt, net, state: ShamirState):
    """Point analog of degree_reduce (single point)."""
    field = spec.scalar_field
    gen = _generator(spec, state.device)
    r_t, r_2t = state.get_pairs(field, 1, net)
    mask2 = _scalar_points(spec, gen, r_2t[0])
    masked = ec.add(spec, pt, mask2)
    n, t = state.n, state.t
    if state.id == KING:
        pts = [masked] + [tuple(net.recv(i)) for i in range(1, 2 * t + 1)]
        acc = point_interpolate(spec, pts, list(range(2 * t + 1)))
        # fresh sharing: share_j = acc + [g(alpha_j)] G with g random deg-t,
        # g(0)=0 (coefficient points are multiples of G)
        coeffs = state._draw(field, (t,))
        for j in range(n):
            gj = None
            for kk in range(t):
                a_pow = mont.constant(field, pow(j + 1, kk + 1, field.p),
                                      device=state.device)
                term = mont.mul(field, coeffs[kk], a_pow)
                gj = term if gj is None else mont.add(field, gj, term)
            share_j = ec.add(spec, acc, _scalar_points(spec, gen, gj))
            if j == KING:
                fresh = share_j
            else:
                net.send(j, share_j)
    else:
        if state.id <= 2 * t:
            net.send(KING, masked)
        fresh = tuple(net.recv(KING))
    mask_t = _scalar_points(spec, gen, r_t[0])
    return ec.add(spec, fresh, ec.neg(spec, mask_t))


def eval_poly(field: Field, coeffs: list, point_mont):
    """Evaluate a secret-shared polynomial at a PUBLIC point via Horner —
    local only (Shamir shares are field elements)."""
    acc = None
    for c in reversed(coeffs):
        if acc is None:
            acc = c
        else:
            acc = mont.add(field, mont.mul(field, acc, point_mont), c)
    if acc is None:
        return mont.encode(field, [0], device=point_mont.device)[0]
    return acc
