"""Port of `cosnarks_tpu.mpc.rep3_scalar`: host Python, copied unchanged
(only this docstring speaks of the card instead of the TPU).

Host-side Rep3 protocol kernel for the circom MPC-VM.

The witness-extension interpreter is round-latency-dominated scalar code —
one driver op per AST node, each possibly a network round (cf. the
reference's interpreter hot loop, circom-mpc-vm/src/mpc_vm.rs:312). That is
the wrong shape for a kernel launch per op (each launch costs more than
the op), so — mirroring the reference, whose VM runs on host CPUs with the
same field semantics as its bulk kernels — the VM's share arithmetic runs
host-side on python ints, while bulk phases (the Groth16/PLONK provers,
batched VM instances) use the device kernels in mpc/rep3.py. Both derive
their correlated randomness from the same 256-bit pairwise keys
(domain-separated BLAKE2b here, ChaCha20 on device).

Protocol surface re-derived from the reference (cited per function):
 - arithmetic: mpc-core/src/protocols/rep3/arithmetic.rs
 - binary XOR shares: rep3/binary.rs
 - A2B "Direct" bit-decomposition, B2A, bit_inject: rep3/conversion.rs:60-433
 - Kogge-Stone adders / comparisons: rep3/detail.rs

Share convention matches mpc/rep3.py (NOT the reference's): party i holds
(a, b) = (x_i, x_{i+1}); public constants live in component x_0, so party 0
applies them to `a` and party 2 to `b`. Replication means b_i == a_{i+1},
so resharing an additive value is send-to-prev / recv-from-next.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

from . import chacha


@dataclasses.dataclass(frozen=True, slots=True)
class AShare:
    """Replicated arithmetic share (a, b) = (x_i, x_{i+1}) as ints mod p.

    Deliberately NOT a tuple subclass: VM input trees treat tuples/lists as
    structure, and a share must stay a leaf."""

    a: int
    b: int


@dataclasses.dataclass(frozen=True, slots=True)
class BShare:
    """Replicated binary (XOR) share (a, b) = (y_i, y_{i+1}) as ints.

    `nbits` is an optional value-width bound (value < 2^nbits) the VM driver
    tracks to pick cheap conversions (bit_inject for 1-bit values, skip the
    mod-p reduction when nbits < field bits); None = unknown/full width."""

    a: int
    b: int
    nbits: int | None = dataclasses.field(default=None, compare=False)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


class HostRng:
    """BLAKE2b-keyed correlated randomness streams for host protocols.

    Counterpart of the reference's Rep3Rand/Rep3RandBitComp
    (rep3/rngs.rs:16-60): `pair` draws advance a counter shared by the two
    parties holding the same key; `solo_*` draws use per-label counters for
    streams only one key-pair participates in (the b2a bit-composition
    randomness, conversion.rs:149-211).
    """

    def __init__(self, key_mine: bytes, key_next: bytes):
        # domain-separate from the device ChaCha streams
        self._km = chacha.derive_key(key_mine, b"host-vm")
        self._kn = chacha.derive_key(key_next, b"host-vm")
        self._ctr: dict[tuple, int] = {}

    @classmethod
    def from_party_rng(cls, party_rng) -> "HostRng":
        return cls(party_rng.key_bytes_mine, party_rng.key_bytes_next)

    def fork(self, idx: int) -> "HostRng":
        label = b"fork" + int(idx).to_bytes(8, "little")
        return HostRng(
            chacha.derive_key(self._km, label), chacha.derive_key(self._kn, label)
        )

    def _draw(self, key: bytes, stream: bytes, ctr: int) -> int:
        """512-bit PRF output (uniform mod 2^nbits for nbits<=512; bias
        < 2^-250 when reduced mod a ~254-bit prime)."""
        h = hashlib.blake2b(
            stream + ctr.to_bytes(8, "little"), key=key, digest_size=64
        )
        return int.from_bytes(h.digest(), "little")

    def _next(self, which: str, stream: bytes) -> int:
        k = (which, stream)
        c = self._ctr.get(k, 0)
        self._ctr[k] = c + 1
        return c

    def pair(self, stream: bytes = b"f") -> tuple[int, int]:
        """(draw from k_i, draw from k_{i+1}) at a common counter."""
        c = self._next("pair", stream)
        return (
            self._draw(self._km, stream, c),
            self._draw(self._kn, stream, c),
        )

    def zero_xor(self, nbits: int) -> int:
        m, n = self.pair(b"zx")
        mask = (1 << nbits) - 1
        return (m & mask) ^ (n & mask)

    def zero_add(self, p: int) -> int:
        m, n = self.pair(b"za")
        return (m - n) % p

    def rand_share(self, p: int) -> AShare:
        m, n = self.pair(b"rs")
        return AShare(m % p, n % p)

    def solo_mine(self, p: int, stream: bytes = b"sm") -> int:
        """Value known to me and the PREVIOUS party (they hold k_i as their
        key_next)."""
        return self._draw(self._km, stream, self._next("mine", stream)) % p

    def solo_next(self, p: int, stream: bytes = b"sn") -> int:
        """Value known to me and the NEXT party (their key_mine = my
        key_next). Stream label must match their solo_mine label."""
        return self._draw(self._kn, stream, self._next("next", stream)) % p

    def solo_mine_bits(self, nbits: int, stream: bytes = b"sb") -> int:
        """nbits (<= 512) shared with the PREVIOUS party (pair with their
        solo_next_bits on the same stream label)."""
        v = self._draw(self._km, stream, self._next("mineb", stream))
        return v & ((1 << nbits) - 1)

    def solo_next_bits(self, nbits: int, stream: bytes = b"sb") -> int:
        v = self._draw(self._kn, stream, self._next("nextb", stream))
        return v & ((1 << nbits) - 1)


class Rep3Scalar:
    """One party's scalar protocol context: id + rng + network + field."""

    def __init__(self, net, rng: HostRng, p: int):
        self.net = net
        self.id = net.id
        self.rng = rng
        self.p = p
        self.k = p.bit_length()  # MODULUS_BIT_SIZE
        self.mask = (1 << self.k) - 1

    def fork(self, idx: int) -> "Rep3Scalar":
        return Rep3Scalar(self.net, self.rng.fork(idx), self.p)

    # -- linear arithmetic (local; arithmetic.rs:32-101) --------------------
    def add(self, x: AShare, y: AShare) -> AShare:
        p = self.p
        return AShare((x.a + y.a) % p, (x.b + y.b) % p)

    def sub(self, x: AShare, y: AShare) -> AShare:
        p = self.p
        return AShare((x.a - y.a) % p, (x.b - y.b) % p)

    def neg(self, x: AShare) -> AShare:
        p = self.p
        return AShare(-x.a % p, -x.b % p)

    def add_public(self, x: AShare, v: int) -> AShare:
        p = self.p
        if self.id == 0:
            return AShare((x.a + v) % p, x.b)
        if self.id == 2:
            return AShare(x.a, (x.b + v) % p)
        # fresh object even when components are unchanged: the VM driver
        # caches domain conversions by object identity, so object lineage
        # must be structurally identical across parties (else caches
        # diverge and the parties desynchronize their network rounds)
        return AShare(x.a, x.b)

    def sub_shared_by_public(self, x: AShare, v: int) -> AShare:
        return self.add_public(x, -v % self.p)

    def sub_public_by_shared(self, v: int, x: AShare) -> AShare:
        return self.add_public(self.neg(x), v)

    def mul_public(self, x: AShare, v: int) -> AShare:
        p = self.p
        return AShare(x.a * v % p, x.b * v % p)

    def promote(self, v: int) -> AShare:
        """promote_to_trivial_share (arithmetic.rs:325)."""
        if self.id == 0:
            return AShare(v % self.p, 0)
        if self.id == 2:
            return AShare(0, v % self.p)
        return AShare(0, 0)

    # -- share/combine (host test plumbing; rep3.rs:112-220) ----------------
    @staticmethod
    def share(v: int, p: int, rand=os.urandom) -> list[AShare]:
        import secrets

        x0, x1 = secrets.randbelow(p), secrets.randbelow(p)
        x2 = (v - x0 - x1) % p
        xs = [x0, x1, x2]
        return [AShare(xs[i], xs[(i + 1) % 3]) for i in range(3)]

    @staticmethod
    def combine(shares: list[AShare], p: int) -> int:
        for i in range(3):
            if shares[i].b != shares[(i + 1) % 3].a:
                raise ValueError("inconsistent replicated shares")
        return (shares[0].a + shares[1].a + shares[2].a) % p

    # -- multiplicative (1 round; arithmetic.rs:104-177) --------------------
    def mul_many(self, xs: list[AShare], ys: list[AShare]) -> list[AShare]:
        p = self.p
        local = [
            (x.a * y.a + x.a * y.b + x.b * y.a + self.rng.zero_add(p)) % p
            for x, y in zip(xs, ys)
        ]
        other = self.net.reshare_backward(local)
        return [AShare(a, b % p) for a, b in zip(local, other)]

    def mul(self, x: AShare, y: AShare) -> AShare:
        return self.mul_many([x], [y])[0]

    def open_many(self, xs: list[AShare]) -> list[int]:
        other = self.net.reshare_backward([x.b for x in xs])
        return [(x.a + x.b + c) % self.p for x, c in zip(xs, other)]

    def open(self, x: AShare) -> int:
        return self.open_many([x])[0]

    def mul_open_many(self, xs, ys) -> list[int]:
        """Fused mul+open, 1 broadcast round (arithmetic.rs:334-358)."""
        p = self.p
        local = [
            (x.a * y.a + x.a * y.b + x.b * y.a + self.rng.zero_add(p)) % p
            for x, y in zip(xs, ys)
        ]
        others = self.net.broadcast(local)
        out = list(local)
        for vals in others.values():
            out = [(o + v) % p for o, v in zip(out, vals)]
        return out

    def inv_many(self, xs: list[AShare]) -> list[AShare]:
        """Masked inversion (arithmetic.rs:217-247)."""
        rs = [self.rng.rand_share(self.p) for _ in xs]
        ys = self.mul_open_many(xs, rs)
        if any(y == 0 for y in ys):
            raise ZeroDivisionError("cannot invert zero share")
        return [
            self.mul_public(r, pow(y, -1, self.p)) for r, y in zip(rs, ys)
        ]

    def inv(self, x: AShare) -> AShare:
        return self.inv_many([x])[0]

    def rand(self) -> AShare:
        return self.rng.rand_share(self.p)

    def cmux(self, c: AShare, t, f) -> AShare:
        """c*t + (1-c)*f for a shared bit c (arithmetic.rs:278)."""
        t = t if isinstance(t, AShare) else self.promote(t)
        f = f if isinstance(f, AShare) else self.promote(f)
        d = self.mul(c, self.sub(t, f))
        return self.add(f, d)

    def pow_public(self, x: AShare, e: int) -> AShare:
        """Square-and-multiply with shared base (arithmetic.rs:410)."""
        res = self.promote(1)
        base = x
        while e > 0:
            if e & 1:
                res = self.mul(res, base)
            base = self.mul(base, base)
            e >>= 1
        return res

    def sqrt(self, x: AShare) -> AShare:
        """Masked square root (arithmetic.rs:367-407): open(r^2 * x) and
        r*y_inv*sqrt(open)."""
        p = self.p
        r_squ = self.rand()
        r_inv = self.rand()
        rr = self.mul(r_squ, r_squ)
        prods = self.mul_many([rr, r_squ], [x, r_inv])
        opened = self.open_many(prods)
        y_sq, y_inv = opened
        if y_inv == 0:
            raise ZeroDivisionError("sqrt masking failure")
        s = _sqrt_mod(y_sq, p)
        if s is None:
            raise ValueError("no square root exists")
        return self.mul_public(r_inv, pow(y_inv, -1, p) * s % p)

    # -- binary XOR domain (binary.rs) --------------------------------------
    def bxor(self, x: BShare, y: BShare) -> BShare:
        return BShare(x.a ^ y.a, x.b ^ y.b)

    def bxor_public(self, x: BShare, v: int) -> BShare:
        if self.id == 0:
            return BShare(x.a ^ v, x.b)
        if self.id == 2:
            return BShare(x.a, x.b ^ v)
        return BShare(x.a, x.b)  # fresh: see add_public

    def band_public(self, x: BShare, v: int) -> BShare:
        return BShare(x.a & v, x.b & v)

    def bshift_r(self, x: BShare, n: int) -> BShare:
        return BShare(x.a >> n, x.b >> n)

    def bshift_l(self, x: BShare, n: int) -> BShare:
        return BShare(x.a << n, x.b << n)

    def bpromote(self, v: int) -> BShare:
        if self.id == 0:
            return BShare(v, 0)
        if self.id == 2:
            return BShare(0, v)
        return BShare(0, 0)

    def band_many(self, xs, ys, nbits: int) -> list[BShare]:
        """Bitwise AND, 1 round (binary.rs:85-125)."""
        local = [
            (x.a & y.a) ^ (x.a & y.b) ^ (x.b & y.a) ^ self.rng.zero_xor(nbits)
            for x, y in zip(xs, ys)
        ]
        other = self.net.reshare_backward(local)
        return [BShare(a, b) for a, b in zip(local, other)]

    def band(self, x: BShare, y: BShare, nbits: int | None = None) -> BShare:
        return self.band_many([x], [y], nbits or self.k)[0]

    def bor(self, x: BShare, y: BShare, nbits: int | None = None) -> BShare:
        return self.bxor(self.bxor(x, y), self.band(x, y, nbits))

    def bor_public(self, x: BShare, v: int) -> BShare:
        return self.bxor(self.bxor_public(x, v), self.band_public(x, v))

    def open_bit_many(self, xs: list[BShare]) -> list[int]:
        other = self.net.reshare_backward([x.b for x in xs])
        return [x.a ^ x.b ^ c for x, c in zip(xs, other)]

    def open_bit(self, x: BShare) -> int:
        return self.open_bit_many([x])[0]

    def bcmux_many(self, cs, ts, fs, nbits: int) -> list[BShare]:
        """Bit-spread multiplexer (binary.rs:222-251)."""
        xors = [self.bxor(f, t) for f, t in zip(fs, ts)]
        ands = self.band_many(cs, xors, nbits)
        return [self.bxor(a, f) for a, f in zip(ands, fs)]

    def _and_twice_many(self, a_list, b1_list, b2_list, nbits: int):
        """Two AND batches in one round (detail.rs:229-289)."""
        la, lb = [], []
        for a, b1, b2 in zip(a_list, b1_list, b2_list):
            m1 = self.rng.zero_xor(nbits)
            m2 = self.rng.zero_xor(nbits)
            la.append((b1.a & a.a) ^ (b1.a & a.b) ^ (b1.b & a.a) ^ m1)
            lb.append((a.a & b2.a) ^ (a.a & b2.b) ^ (a.b & b2.a) ^ m2)
        other = self.net.reshare_backward((la, lb))
        oa, ob = other
        r1 = [BShare(x, y) for x, y in zip(la, oa)]
        r2 = [BShare(x, y) for x, y in zip(lb, ob)]
        return r1, r2

    # -- Kogge-Stone adders (detail.rs:18-321) ------------------------------
    def _kogge_stone_many(self, ps, gs, bitlen: int) -> list[BShare]:
        """Parallel-prefix carry network; output has bitlen+1 bits."""
        d = _ceil_log2(bitlen)
        s0 = list(ps)
        ps = list(ps)
        gs = list(gs)
        for i in range(d):
            shift = 1 << i
            mask = (1 << (bitlen - shift)) - 1
            p_sh = [self.bshift_r(x, shift) for x in ps]
            g_m = [self.band_public(x, mask) for x in gs]
            p_m = [self.band_public(x, mask) for x in ps]
            r1, r2 = self._and_twice_many(p_sh, g_m, p_m, bitlen - shift)
            ps = [self.bshift_l(x, shift) for x in r2]
            gs = [
                self.bxor(g, self.bshift_l(x, shift)) for g, x in zip(gs, r1)
            ]
        return [
            self.bxor(self.bshift_l(g, 1), s) for g, s in zip(gs, s0)
        ]

    def binary_add_many(self, xs, ys, bitlen: int) -> list[BShare]:
        ps = [self.bxor(x, y) for x, y in zip(xs, ys)]
        gs = self.band_many(xs, ys, bitlen)
        return self._kogge_stone_many(ps, gs, bitlen)

    def binary_sub_many(self, xs, ys, bitlen: int) -> list[BShare]:
        """2^bitlen + x - y (two's complement; detail.rs:195-217). The
        carry-out bit at position `bitlen` is the unsigned x >= y flag."""
        mask = (1 << bitlen) - 1
        yn = [self.bxor_public(y, mask) for y in ys]
        ps = [self.bxor(x, y) for x, y in zip(xs, yn)]
        gs = self.band_many(xs, yn, bitlen)
        gs = [
            self.bxor(g, self.band_public(p, 1)) for g, p in zip(gs, ps)
        ]  # carry_in = 1
        res = self._kogge_stone_many(ps, gs, bitlen)
        return [self.bxor_public(r, 1) for r in res]

    def _binary_sub_p_many(self, xs, bitlen: int) -> list[BShare]:
        """x + (2^bitlen - p) (detail.rs:291-321)."""
        p_ = (1 << bitlen) - self.p
        gs = [self.band_public(x, p_) for x in xs]
        ps = [self.bxor_public(x, p_) for x in xs]
        return self._kogge_stone_many(ps, gs, bitlen)

    def _sub_p_cmux_many(self, xs, bitlen: int) -> list[BShare]:
        """Conditionally subtract p after an add (detail.rs:130-192).
        bitlen includes the add's overflow bit."""
        orig = bitlen - 1
        mask = (1 << orig) - 1
        ys = self._binary_sub_p_many(xs, bitlen)
        ovs = []
        for y in ys:
            # branchless bit-spread (also keeps this elementwise for the
            # batched driver, where components are numpy object vectors)
            ov_a = ((y.a >> bitlen) & 1) * mask
            ov_b = ((y.b >> bitlen) & 1) * mask
            ovs.append(BShare(ov_a, ov_b))
        ys = [self.band_public(y, mask) for y in ys]
        xs = [self.band_public(x, mask) for x in xs]
        return self.bcmux_many(ovs, ys, xs, orig)

    def binary_add_mod_p_many(self, xs, ys, bitlen: int) -> list[BShare]:
        z = self.binary_add_many(xs, ys, bitlen)
        return self._sub_p_cmux_many(z, bitlen + 1)

    # -- conversions (conversion.rs) ----------------------------------------
    def a2b_many(self, xs: list[AShare]) -> list[BShare]:
        """Arithmetic -> binary via Direct bit-decomposition
        (conversion.rs:60-143): x = (x_0+x_1) + x_2; party 0 (who holds
        both) xor-shares the first summand, parties 1/2 already hold a
        binary sharing of x_2 in their replicated components; one binary
        mod-p add recombines."""
        k = self.k
        contribs = []
        x2s = []
        for x in xs:
            r = self.rng.zero_xor(k)
            if self.id == 0:
                contribs.append(((x.a + x.b) % self.p) ^ r)
                x2s.append(BShare(0, 0))
            elif self.id == 1:
                contribs.append(r)
                x2s.append(BShare(0, x.b))
            else:
                contribs.append(r)
                x2s.append(BShare(x.a, 0))
        other = self.net.reshare_backward(contribs)
        x01s = [BShare(a, b) for a, b in zip(contribs, other)]
        return self.binary_add_mod_p_many(x01s, x2s, k)

    def a2b(self, x: AShare) -> BShare:
        return self.a2b_many([x])[0]

    def b2a_many(self, xs: list[BShare]) -> list[AShare]:
        """Binary -> arithmetic via Bit Composition (conversion.rs:149-297):
        mask with r2+r3 (pairwise-seeded), open z = x + r2 + r3 in binary
        to the two parties holding component x'_0, output additive
        decomposition (z, -r2, -r3)."""
        k, p = self.k, self.p
        contribs = []
        res_parts = []  # per element: what we know of (a, b) pre-open
        for _ in xs:
            r = self.rng.zero_xor(k)
            if self.id == 0:
                r2 = self.rng.solo_next(p, b"bc01")
                contribs.append(r)
                res_parts.append((None, -r2 % p))
            elif self.id == 1:
                r2 = self.rng.solo_mine(p, b"bc01")
                r3 = self.rng.solo_next(p, b"bc12")
                contribs.append(((r2 + r3) % p) ^ r)
                res_parts.append((-r2 % p, -r3 % p))
            else:
                r3 = self.rng.solo_mine(p, b"bc12")
                contribs.append(r)
                res_parts.append((-r3 % p, None))
        other = self.net.reshare_backward(contribs)
        ys = [BShare(a, b) for a, b in zip(contribs, other)]
        zs = self.binary_add_mod_p_many(xs, ys, k)
        # open z to parties 0 and 2 (they hold component x'_0 = z)
        if self.id == 0:
            self.net.send(2, [z.b for z in zs])
            rcv = self.net.recv(1)
            out = []
            for z, c, (_, b) in zip(zs, rcv, res_parts):
                out.append(AShare((z.a ^ z.b ^ c) % p, b))
            return out
        if self.id == 1:
            self.net.send(0, [z.b for z in zs])
            return [AShare(a, b) for (a, b) in res_parts]
        self_rcv = self.net.recv(0)
        out = []
        for z, c, (a, _) in zip(zs, self_rcv, res_parts):
            out.append(AShare(a, (z.a ^ z.b ^ c) % p))
        return out

    def b2a(self, x: BShare) -> AShare:
        return self.b2a_many([x])[0]

    def bit_inject_many(self, xs: list[BShare]) -> list[AShare]:
        """Single-bit binary share -> arithmetic share of the same bit
        (conversion.rs:300-433, the arithmetic-xor construction of
        eprint 2025/919): v = w ^ y with w = y_0^y_1 (party 0 knows it)
        and y = y_2 (parties 1, 2 know it); v = w + y - 2wy computed with
        one zero-additive masking round."""
        p = self.p
        if self.id == 0:
            outs = []
            for x in xs:
                w = (x.a ^ x.b) & 1
                z0 = self.rng.zero_add(p)
                outs.append((z0 + w) % p)
            self.net.send(2, outs)  # to prev
            rcv = self.net.recv(1)  # from next
            return [AShare(a, b) for a, b in zip(outs, rcv)]
        if self.id == 1:
            outs = []
            for x in xs:
                y = x.b & 1
                z1 = self.rng.zero_add(p)
                outs.append((z1 + y * (1 - 2 * z1)) % p)
            self.net.send(0, outs)
            rcv = self.net.recv(2)
            return [AShare(a, b) for a, b in zip(outs, rcv)]
        rcv = self.net.recv(0)  # r_0 from party 0
        outs = []
        for x, r0 in zip(xs, rcv):
            y = x.a & 1
            z2 = self.rng.zero_add(p)
            t = y * (r0 + z2) % p
            outs.append((z2 - 2 * t) % p)
        self.net.send(1, outs)
        return [AShare(a, b) for a, b in zip(outs, rcv)]

    def bit_inject(self, x: BShare) -> AShare:
        return self.bit_inject_many([x])[0]

    # -- comparisons (detail.rs:323-403, arithmetic.rs:430-720) -------------
    # All are on the raw field order ("unsigned"); signed circom semantics
    # are applied by the VM driver via the p/2+1 shift (mpc/rep3.rs:89-101).

    def unsigned_ge_bit(self, x: AShare, y: AShare) -> BShare:
        xb, yb = self.a2b_many([x, y])
        diff = self.binary_sub_many([xb], [yb], self.k)[0]
        return self.band_public(self.bshift_r(diff, self.k), 1)

    def unsigned_ge_public_bit(self, x: AShare, c: int) -> BShare:
        """[x] >= c (detail.rs:351-379)."""
        xb = self.a2b(x)
        c2 = (1 << self.k) - (c % self.p)
        ps = self.bxor_public(xb, c2)
        gs = self.band_public(xb, c2)
        res = self._kogge_stone_many([ps], [gs], self.k)[0]
        return self.band_public(self.bshift_r(res, self.k), 1)

    def unsigned_ge_const_lhs_bit(self, c: int, y: AShare) -> BShare:
        """c >= [y] (detail.rs:338-348,382-403)."""
        yb = self.a2b(y)
        yn = self.bxor_public(yb, self.mask)
        ps = self.bxor_public(yn, c % self.p)
        gs = self.band_public(yn, c % self.p)
        gs = self.bxor(gs, self.band_public(ps, 1))  # carry_in = 1
        res = self._kogge_stone_many([ps], [gs], self.k)[0]
        res = self.bxor_public(res, 1)
        return self.band_public(self.bshift_r(res, self.k), 1)

    def ge(self, x: AShare, y: AShare) -> AShare:
        return self.bit_inject(self.unsigned_ge_bit(x, y))

    def ge_public(self, x: AShare, c: int) -> AShare:
        return self.bit_inject(self.unsigned_ge_public_bit(x, c))

    def le_public(self, x: AShare, c: int) -> AShare:
        return self.bit_inject(self.unsigned_ge_const_lhs_bit(c, x))

    def lt(self, x: AShare, y: AShare) -> AShare:
        return self.sub_public_by_shared(1, self.ge(x, y))

    def lt_public(self, x: AShare, c: int) -> AShare:
        return self.sub_public_by_shared(1, self.ge_public(x, c))

    def gt_public(self, x: AShare, c: int) -> AShare:
        return self.sub_public_by_shared(1, self.le_public(x, c))

    def le(self, x: AShare, y: AShare) -> AShare:
        return self.ge(y, x)

    def gt(self, x: AShare, y: AShare) -> AShare:
        return self.sub_public_by_shared(1, self.le(x, y))

    def bin_is_zero_many(self, xs: list[BShare]) -> list[BShare]:
        """AND-tree over negated bits (binary.rs:292-367)."""
        ln = self.k
        xs = [
            self.band_public(self.bxor_public(x, self.mask), self.mask)
            for x in xs
        ]
        while ln > 1:
            if ln % 2 == 1:
                ln += 1
                xs = [
                    BShare(
                        x.a | (1 << (ln - 1)), x.b | (1 << (ln - 1))
                    )
                    for x in xs
                ]
            ln //= 2
            m = (1 << ln) - 1
            his = [self.band_public(self.bshift_r(x, ln), m) for x in xs]
            los = [self.band_public(x, m) for x in xs]
            xs = self.band_many(los, his, ln)
        return [self.band_public(x, 1) for x in xs]

    def eq_bit_many(self, xs, ys) -> list[BShare]:
        diffs = [self.sub(x, y) for x, y in zip(xs, ys)]
        return self.bin_is_zero_many(self.a2b_many(diffs))

    def eq(self, x: AShare, y: AShare) -> AShare:
        return self.bit_inject(self.eq_bit_many([x], [y])[0])

    def eq_public(self, x: AShare, c: int) -> AShare:
        return self.eq(x, self.promote(c))

    def neq(self, x: AShare, y: AShare) -> AShare:
        return self.sub_public_by_shared(1, self.eq(x, y))

    def is_zero_open(self, x: AShare) -> bool:
        """Opens only the zero/nonzero predicate (arithmetic.rs:711)."""
        bit = self.eq_bit_many([x], [self.promote(0)])[0]
        return self.open_bit(bit) == 1


def _sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks (host oracle for the masked sqrt protocol)."""
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r
