"""Port of `cosnarks_tpu.vm.shamir_driver`: host Python, copied unchanged.

Shamir VM driver for the circom witness-extension interpreter.

Counterpart of the reference's CircomShamirVmWitnessExtension
(co-circom/circom-mpc-vm/src/mpc/shamir.rs): arithmetic over degree-t
Shamir shares for any (n, t) with n >= 2t+1. Like the reference's
driver, the binary/comparison surface is NOT available in the Shamir
domain (no XOR sharing; shamir.rs leaves those unimplemented) — bit
ops, comparisons, and shifts raise, so arithmetic circuits (MiMC,
Poseidon, multipliers) run and bit-twiddling ones fall back to Rep3.

The host scalar ops share the correlated-pair machinery with the device
protocol (mpc/shamir.py ShamirState, DN07 double shares): each
multiplication masks the degree-2t local product with an r_2t pair
share, opens it (degree-2t interpolation over 2t+1 broadcast shares),
and subtracts the degree-t pair share — one broadcast round, batched
across every product in flight.
"""

from __future__ import annotations

import dataclasses

from ..ff.spec import Field
from ..mpc import shamir
from .interp import CircomError, PlainDriver


@dataclasses.dataclass(frozen=True, slots=True)
class SShare:
    """Degree-t Shamir share (an int mod p). A dataclass (not a bare int)
    so VM trees can tell shares from public values."""

    v: int


class ShamirScalar:
    """One party's host-side Shamir protocol context. Correlated (r_t,
    r_2t) double shares are produced on demand with the simple DN07 sum
    (every party contributes a random value shared at both degrees; the
    sum is uniform as long as one party is honest) — the batched
    Vandermonde extraction of the device path (mpc/shamir.py) is
    unnecessary at VM round volumes."""

    def __init__(self, net, field: Field, rng=None):
        import random as _random

        self.net = net
        self.field = field
        self.p = field.p
        self.id = net.id
        self.n = net.n_parties
        self.t = getattr(net, "_shamir_t", 1)
        self._rng = rng or _random.SystemRandom()
        self._rt: list[int] = []
        self._r2t: list[int] = []
        # lagrange_at_zero takes 0-based ids (evaluation point = id + 1)
        self._lag_all = shamir.lagrange_at_zero(
            field, list(range(net.n_parties)))

    def _share_at(self, v: int, deg: int) -> list[int]:
        p = self.p
        coeffs = [v] + [self._rng.randrange(p) for _ in range(deg)]
        out = []
        for i in range(self.n):
            x, acc, xp = i + 1, 0, 1
            for c in coeffs:
                acc = (acc + c * xp) % p
                xp = xp * x % p
            out.append(acc)
        return out

    def _refill(self, k: int):
        k = max(k, 64)
        p = self.p
        mine_t, mine_2t = [], []
        for _ in range(k):
            v = self._rng.randrange(p)
            mine_t.append(self._share_at(v, self.t))
            mine_2t.append(self._share_at(v, 2 * self.t))
        for j in range(self.n):
            if j != self.id:
                self.net.send(j, ([row[j] for row in mine_t],
                                  [row[j] for row in mine_2t]))
        sum_t = [row[self.id] for row in mine_t]
        sum_2t = [row[self.id] for row in mine_2t]
        for j in range(self.n):
            if j == self.id:
                continue
            got_t, got_2t = self.net.recv(j)
            sum_t = [(a + b) % p for a, b in zip(sum_t, got_t)]
            sum_2t = [(a + b) % p for a, b in zip(sum_2t, got_2t)]
        self._rt.extend(sum_t)
        self._r2t.extend(sum_2t)

    def _pairs(self, k: int) -> tuple[list[int], list[int]]:
        if len(self._rt) < k:
            self._refill(k - len(self._rt))
        rt, self._rt = self._rt[:k], self._rt[k:]
        r2t, self._r2t = self._r2t[:k], self._r2t[k:]
        return rt, r2t

    def open_many(self, xs: list[int], degree: int | None = None):
        """Broadcast + interpolate at zero over ALL parties (uses every
        share; valid for degree <= n-1, so both t and 2t)."""
        got = self.net.broadcast([x % self.p for x in xs])
        cols = [got.get(i, None) for i in range(self.net.n_parties)]
        cols[self.id] = [x % self.p for x in xs]
        out = []
        for j in range(len(xs)):
            acc = 0
            for i, lam in enumerate(self._lag_all):
                acc = (acc + lam * cols[i][j]) % self.p
            out.append(acc)
        return out

    def mul_many(self, xs, ys) -> list[int]:
        p = self.p
        rt, r2t = self._pairs(len(xs))
        masked = [(x * y + r2) % p for x, y, r2 in zip(xs, ys, r2t)]
        opened = self.open_many(masked)
        return [(o - r) % p for o, r in zip(opened, rt)]

    def mul_open_many(self, xs, ys) -> list[int]:
        return self.open_many([x * y % self.p for x, y in zip(xs, ys)])

    def rand_many(self, k: int) -> list[int]:
        return self._pairs(k)[0]

    def inv_many(self, xs) -> list[int]:
        """Masked inversion: open x*r, share r/(x*r)."""
        rs = self.rand_many(len(xs))
        ys = self.mul_open_many(xs, rs)
        if any(y == 0 for y in ys):
            raise ZeroDivisionError("cannot invert zero share")
        return [r * pow(y, -1, self.p) % self.p for r, y in zip(rs, ys)]


class ShamirVmDriver:
    """VM driver over ShamirScalar; values are public ints or SShare."""

    def __init__(self, proto: ShamirScalar, field: Field):
        self.pr = proto
        self.p = field.p
        self.field = field
        self._plain = PlainDriver(field)
        self._deferred: list = []

    def is_shared(self, x) -> bool:
        return isinstance(x, SShare)

    def norm(self, x):
        return x if isinstance(x, SShare) else int(x) % self.p

    def to_share(self, x) -> SShare:
        # public -> constant polynomial share (promote_to_trivial)
        return x if isinstance(x, SShare) else SShare(int(x) % self.p)

    def open(self, x):
        return self.pr.open_many([x.v])[0] if self.is_shared(x) else x

    def _bin2(self, a, b, plain_fn, share_fn):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return plain_fn(a, b)
        return share_fn(self.to_share(a).v, self.to_share(b).v)

    def add(self, a, b):
        return self._bin2(a, b, self._plain.add,
                          lambda x, y: SShare((x + y) % self.p))

    def sub(self, a, b):
        return self._bin2(a, b, self._plain.sub,
                          lambda x, y: SShare((x - y) % self.p))

    def neg(self, a):
        if not self.is_shared(a):
            return self._plain.neg(a)
        return SShare(-a.v % self.p)

    def mul(self, a, b):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.mul(a, b)
        if sa and sb:
            return SShare(self.pr.mul_many([a.v], [b.v])[0])
        s, v = (a, b) if sa else (b, a)
        return SShare(s.v * (int(v) % self.p) % self.p)

    def mul_many(self, xs, ys):
        out: list = [None] * len(xs)
        bx, by, bidx = [], [], []
        for i, (a, b) in enumerate(zip(xs, ys)):
            if self.is_shared(a) and self.is_shared(b):
                bx.append(a.v)
                by.append(b.v)
                bidx.append(i)
            else:
                out[i] = self.mul(a, b)
        if bidx:
            for i, r in zip(bidx, self.pr.mul_many(bx, by)):
                out[i] = SShare(r)
        return out

    def div(self, a, b):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.div(a, b)
        if not sb:
            if int(b) % self.p == 0:
                raise CircomError("division by zero")
            return self.mul(a, pow(int(b), -1, self.p))
        inv_b = SShare(self.pr.inv_many([b.v])[0])
        return self.mul(a if sa else int(a) % self.p, inv_b)

    def pow(self, a, b):
        if self.is_shared(b):
            raise CircomError("pow with shared exponent unsupported")
        if not self.is_shared(a):
            return self._plain.pow(a, b)
        e = int(b)
        if e == 0:
            return 1
        res, base = None, a
        while e:
            if e & 1:
                res = base if res is None else self.mul(res, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return res

    def cmux(self, c, t, f):
        if not self.is_shared(c):
            return t if self._plain.is_true(c) else f
        d = self.mul(c, self.sub(self.norm(t), self.norm(f)))
        return self.add(self.norm(f), d)

    def land(self, a, b):
        if not self.is_shared(a) and not self.is_shared(b):
            return self._plain.land(a, b)
        return self.mul(a, b)

    def lor(self, a, b):
        if not self.is_shared(a) and not self.is_shared(b):
            return self._plain.lor(a, b)
        return self.sub(self.add(a, b), self.mul(a, b))

    def lnot(self, a):
        if not self.is_shared(a):
            return self._plain.lnot(a)
        return self.sub(1, a)

    def is_true(self, a):
        if self.is_shared(a):
            raise CircomError(
                "data-dependent control flow on a Shamir-shared value")
        return a != 0

    # deferred batch-verified `===` checks (same scheme as the Rep3 driver)
    def assert_eq(self, l, r, ctx=""):
        if not self.is_shared(l) and not self.is_shared(r):
            return self._plain.assert_eq(l, r, ctx)
        self._deferred.append(
            (self.sub(self.to_share(l), self.to_share(r)), ctx))
        if len(self._deferred) >= 8192:
            self.flush_asserts()

    def flush_asserts(self):
        if not self._deferred:
            return
        diffs = [d.v for d, _ in self._deferred]
        ctxs = [c for _, c in self._deferred]
        self._deferred = []
        rs = self.pr.rand_many(len(diffs))
        vals = self.pr.mul_open_many(diffs, rs)
        bad = [ctxs[i] for i, v in enumerate(vals) if v != 0]
        if bad:
            raise CircomError(
                f"constraint violated{bad[0]} (on shared values; "
                f"{len(bad)} of {len(vals)} checks in batch failed)")

    def assert_true(self, c, ctx=""):
        if not self.is_shared(c):
            return self._plain.assert_true(c, ctx)
        rs = self.pr.rand_many(1)
        prod = self.pr.mul_open_many([(c.v - 1) % self.p], rs)
        if prod[0] != 0:
            raise CircomError(f"assert failed{ctx} (on shared value)")

    def sqrt(self, a):
        if not self.is_shared(a):
            return self._plain.sqrt(a)
        raise CircomError("sqrt on Shamir shares unsupported (use Rep3)")

    # -- binary domain: not representable in Shamir (shamir.rs parity);
    # public-only calls still run on the plain driver -------------------------
    def _gate(self, plain_fn, *args):
        flat = []
        for x in args:
            flat.extend(x) if isinstance(x, list) else flat.append(x)
        if not any(self.is_shared(v) for v in flat):
            return plain_fn(*args)
        raise CircomError(
            "bit operations are unsupported on Shamir shares "
            "(reference circom-mpc-vm mpc/shamir.rs leaves these "
            "unimplemented); use the Rep3 driver")

    def band(self, a, b):
        return self._gate(self._plain.band, a, b)

    def bor(self, a, b):
        return self._gate(self._plain.bor, a, b)

    def bxor(self, a, b):
        return self._gate(self._plain.bxor, a, b)

    def bnot(self, a):
        return self._gate(self._plain.bnot, a)

    def shl(self, a, k):
        return self._gate(self._plain.shl, a, k)

    def shr(self, a, k):
        return self._gate(self._plain.shr, a, k)

    def lt(self, a, b):
        return self._gate(self._plain.lt, a, b)

    def le(self, a, b):
        return self._gate(self._plain.le, a, b)

    def eq(self, a, b):
        return self._gate(self._plain.eq, a, b)

    def neq(self, a, b):
        return self._gate(self._plain.neq, a, b)

    def num2bits(self, a, n):
        return self._gate(self._plain.num2bits, a, n)

    def addbits(self, a_bits, b_bits):
        return self._gate(self._plain.addbits, a_bits, b_bits)

    def idiv(self, a, b):
        return self._gate(self._plain.idiv, a, b)

    def mod(self, a, b):
        return self._gate(self._plain.mod, a, b)


def setup_shamir_vm(net, field: Field, t: int = 1, pairs: int = 256,
                    seed: bytes | None = None) -> ShamirVmDriver:
    if 2 * t + 1 > net.n_parties:
        raise ValueError("threshold too large")
    net._shamir_t = t
    return ShamirVmDriver(ShamirScalar(net, field), field)


def share_value(field: Field, v: int, n: int, t: int,
                rng=None) -> list[SShare]:
    import random as _random

    rng = rng or _random.SystemRandom()
    p = field.p
    coeffs = [int(v) % p] + [rng.randrange(p) for _ in range(t)]
    out = []
    for i in range(n):
        x, acc, xp = i + 1, 0, 1
        for c in coeffs:
            acc = (acc + c * xp) % p
            xp = xp * x % p
        out.append(SShare(acc))
    return out


def combine_shares(field: Field, shares: list[SShare],
                   party_ids: list[int]) -> int:
    """party_ids are 0-based (evaluation points id + 1)."""
    lam = shamir.lagrange_at_zero(field, party_ids)
    return sum(l * s.v for l, s in zip(lam, shares)) % field.p
