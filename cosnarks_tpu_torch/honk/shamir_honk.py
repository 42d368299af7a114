"""Shamir driver for the collaborative UltraHonk prover: PyTorch port of
cosnarks_tpu.honk.shamir_honk.

Counterpart of the reference's ShamirCoUltraHonk
(co-ultrahonk/src/co_ultra_prover.rs:115 and the Shamir impl of
NoirUltraHonkProver, co-noir-common/src/mpc/shamir.rs): n parties,
threshold t with 2t < n, the witness polynomials Shamir-shared. A share is
ONE (k, 16) Montgomery limb tensor on the device (the polynomial evaluated
at the party's point id + 1), so every linear step of the co-prover is one
launch, as in the plain prover. `co_prover.co_prove` runs unchanged over
this driver: `SVec` (honk/co_driver.py) routes each operation through it.

Protocol (semi-honest, honest majority), on the port's device Shamir
(`mpc/shamir.py`):
- multiplication: the local product is a degree-2t sharing, reduced to
  degree t with a double-share pair (r_t, r_2t) of `ShamirState`: every
  party broadcasts its share of x*y + r_2t, all interpolate that masked,
  public-safe value (`shamir.open` at degree 2t) and take r_t off. One
  round, and no fresh randomness per product: `shamir.mul`'s king
  reshares with a ChaCha draw per product, whose fixed cost made a
  128-row CPU co-proof 140 s against this one's time (PERF.md). The pairs
  are refilled (DN07) in batches of 2^20 on the card (2^14 on the CPU): a
  2^16-row proof takes about 2^25 products, so a refill per product would
  cost more launches than the proof, one for the whole proof more memory
  than it needs.
- `mul_open`: the degree-2t product interpolated from 2t + 1 <= n shares.
- inversions and prefix products: the Rep3 driver's masking schedule,
  with random degree-t shares (the pairs' r_t) as masks.
- commitments: each party commits to its share (`polyops.commit`, `msm()`
  on a device CRS) and broadcasts the affine point; the commitment is the
  Lagrange-at-zero combination of the n points on the host curve.

The JAX package's driver computes on Python ints and deals fresh
randomness per call (two deals and a broadcast per product); its rounds
differ from these, its opened values and proofs do not.
`shamir_share`, `_lagrange0` and `share_proving_key_shamir` are its
functions, copied: the same `random.Random` gives the same ints.
"""

from __future__ import annotations

import torch

from ..ec import curves
from ..ec.host import host_curve
from ..mpc import shamir
from ..plonk.prove import scan
from ..utils import timing
from . import polyops
from .co_driver import SVec, _decode_pt, _encode_pt
from .polyops import FR, R


def _lagrange0(xs: list[int]) -> list[int]:
    """Lagrange coefficients at 0 for sample points xs (mod R)."""
    out = []
    for j, xj in enumerate(xs):
        num = den = 1
        for k, xk in enumerate(xs):
            if k == j:
                continue
            num = num * xk % R
            den = den * ((xk - xj) % R) % R
        out.append(num * pow(den, -1, R) % R)
    return out


def shamir_share(value: int, t: int, n: int, rng) -> list[int]:
    """One Shamir sharing of `value`: degree-t polynomial evals at 1..n."""
    coeffs = [value % R] + [rng.randrange(R) for _ in range(t)]
    shares = []
    for x in range(1, n + 1):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % R
        shares.append(acc)
    return shares


class ShamirHonkDriver:
    """Whole-vector Shamir protocol over device shares, bound to a party
    network and its `shamir.ShamirState` (n parties, threshold t). Also
    the `ops` object of the prover's generic sumcheck and opening phases.
    `rounds` counts message rounds (a product, an open, a commitment and
    a pair refill one each), `refills` the pair refills."""

    def __init__(self, net, state: shamir.ShamirState):
        if 2 * state.t + 1 > state.n:
            raise ValueError("need n >= 2t + 1")
        self.net = net
        self.state = state
        self.id = net.id
        self.n = state.n
        self.t = state.t
        self.device = state.device
        self.rounds = 0
        self.refills = 0
        self.batch = 1 << (20 if self.device.type == "cuda" else 14)
        # interpolating over all n points reconstructs any polynomial of
        # degree <= n - 1, which covers the partial commitments
        self.lag = _lagrange0(list(range(1, self.n + 1)))

    # -- construction -------------------------------------------------------
    def wrap(self, t) -> SVec:
        """SVec from the share's component tensor (`comps`' inverse)."""
        return SVec(t, self)

    vec = wrap

    @staticmethod
    def comps(x) -> tuple:
        return (x,)

    @staticmethod
    def to_share(col, device) -> torch.Tensor:
        """A column of host share ints, or a limb tensor, on `device`."""
        if isinstance(col, torch.Tensor):
            return col.to(device)
        return polyops.encode([int(v) for v in col], device)

    @staticmethod
    def promote(t):
        """Public tensor -> share: a constant polynomial."""
        return shamir.promote_public(FR, t)

    def rand(self, k: int) -> torch.Tensor:
        """k random degree-t shares (the r_t of k pairs)."""
        self._reserve(k)
        return shamir.rand(FR, self.state, (k,))

    # -- the prover's ops interface ------------------------------------------
    @staticmethod
    def lin(fn, *xs):
        return fn(*xs)

    @staticmethod
    def add(x, y):
        return shamir.add(FR, x, y)

    @staticmethod
    def sub(x, y):
        return shamir.sub(FR, x, y)

    @staticmethod
    def neg(x):
        return shamir.neg(FR, x)

    @staticmethod
    def add_public(x, v):
        """x + v: every share shifts (a constant polynomial)."""
        return shamir.add_public(FR, x, v)

    @staticmethod
    def mul_public(x, v):
        return shamir.mul_public(FR, x, v)

    def zeros(self, k: int) -> torch.Tensor:
        return polyops.zeros(k, self.device)

    def open(self, x) -> list[int]:
        return polyops.decode(self.open_t(x), "honk.open")

    def commit(self, poly, crs):
        return self.commit_open(poly, crs)

    # -- protocol -----------------------------------------------------------
    def _reserve(self, k: int) -> None:
        """Make k pairs ready, refilling a batch (one round) when short, so
        that every party refills at the same point."""
        st = self.state
        if st.pos + k > st.r_t.shape[0]:
            st.refill_pairs(FR, self.net, max(k, self.batch))
            self.refills += 1
            self.rounds += 1

    def mul(self, x, y):
        """Degree-t share of x * y in one round: every party broadcasts
        its degree-2t share of x * y + r (a pair's r_2t added), all
        interpolate that public-safe value and take r_t off."""
        k = x.shape[0]
        self._reserve(k)
        self.rounds += 1
        r_t, r_2t = self.state.get_pairs(FR, k)
        masked = shamir.add(FR, shamir.local_mul(FR, x, y), r_2t)
        opened = shamir.open(FR, masked, self.net, self.state,
                             degree=2 * self.t)
        return shamir.sub(FR, opened, r_t)

    def mul_vec(self, x: SVec, y: SVec) -> SVec:
        return SVec(self.mul(x.s, y.s), self)

    def open_t(self, x) -> torch.Tensor:
        self.rounds += 1
        return shamir.open(FR, x, self.net, self.state)

    def mul_open(self, x, y) -> torch.Tensor:
        """Open x * y from the degree-2t local products (one round)."""
        self.rounds += 1
        return shamir.open(FR, shamir.local_mul(FR, x, y), self.net,
                           self.state, degree=2 * self.t)

    def inv_vec_leaking_zeros(self, x):
        """Masked batch inversion; zero entries open as zero and stay zero
        (CoUtils::batch_invert_leaking_zeros)."""
        r = self.rand(x.shape[0])
        return self.mul_public(r, polyops.batch_invert(self.mul_open(x, r)))

    def inv_vec(self, x):
        r = self.rand(x.shape[0])
        opened = self.mul_open(x, r)
        with timing.blocking("honk.inv_check"):
            zero = bool((opened == 0).all(-1).any())
        if zero:
            raise ZeroDivisionError("cannot invert zero share")
        return self.mul_public(r, polyops.batch_invert(opened))

    def array_prod_mul(self, arr):
        """Constant-round prefix products out[i] = prod_{j<=i} arr[j], the
        Rep3 driver's schedule (co-plonk/src/mpc/shamir.rs)."""
        n = arr.shape[0]
        r = self.rand(n + 1)
        r_inv = self.inv_vec(r)
        unblind = self.mul(r_inv[:1].expand(n, -1), r[1:])
        masked = self.mul(r[:n], arr)
        opened = self.mul_open(masked, r_inv[1:])
        return self.mul_public(unblind, scan(polyops.mul, opened))

    # -- EC commitments -----------------------------------------------------
    def commit_open(self, coeffs, crs):
        """Commit to a shared polynomial and open the commitment: each
        party commits to its share (`polyops.commit`: `msm()` on a device
        CRS), the n affine points are exchanged and combined with the
        Lagrange coefficients at zero on the host (the pointshare open of
        the reference's Shamir driver). A party's point may be the
        identity."""
        mine = polyops.commit(coeffs, crs)
        others = self.net.broadcast(_encode_pt(mine))
        self.rounds += 1
        pts = {j: _decode_pt(enc) for j, enc in others.items()}
        pts[self.id] = mine
        g1 = host_curve(curves.BN254_G1)
        acc = None
        for j in sorted(pts):
            if pts[j] is not None:
                acc = g1.add(acc, g1.mul(g1.lift_affine(pts[j]),
                                         self.lag[j]))
        return g1.affine_ints(acc) if acc is not None else None


def share_proving_key_shamir(pk, rng, n_parties: int = 3,
                             t: int = 1) -> list[dict]:
    """Split the witness polynomials of a plain proving key into n Shamir
    share dicts of ints (reference split_proving_key_shamir,
    co-noir/src/lib.rs)."""
    from .co_prover import SHARED_PK_ENTITIES

    per_party = [dict() for _ in range(n_parties)]
    for name in SHARED_PK_ENTITIES:
        cols = [[] for _ in range(n_parties)]
        for v in pk.polynomials[name]:
            sh = shamir_share(int(v), t, n_parties, rng)
            for i in range(n_parties):
                cols[i].append(sh[i])
        for i in range(n_parties):
            per_party[i][name] = cols[i]
    return per_party
