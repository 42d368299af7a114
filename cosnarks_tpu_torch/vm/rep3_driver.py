"""Port of `cosnarks_tpu.vm.rep3_driver`: host Python, copied unchanged
(only the docstrings drop the JAX package's TPU reasoning).

Rep3 MPC driver for the circom witness-extension interpreter.

Counterpart of the reference's CircomRep3VmWitnessExtension
(co-circom/circom-mpc-vm/src/mpc/rep3.rs): VM values are public python
ints, replicated arithmetic shares (AShare) or replicated binary shares
(BShare — the reference's Rep3VmType::Binary). Values stay LAZILY in the
binary domain across chains of bit ops (xor/and/or/shifts/mod-2^k are
free or one round there), converting to arithmetic only when an
arithmetic op or a signal write needs them — this is what makes
bit-twiddling witness hints (SHA-256's sha256compression function) feasible:
the eager formulation pays a full A2B+B2A (two Kogge-Stone adders) per
bit op.

Width tracking: BShare.nbits bounds the value; 1-bit values convert via
bit_inject (one round instead of an adder chain), and values bounded
below the field width skip the mod-p reduction on conversion.

Comparisons apply circom's signed semantics by shifting with p/2+1 before
unsigned comparison (mpc/rep3.rs:89-101); bit decomposition routes through
A2B Direct (our default, as in the JAX package; the reference defaults to
Yao, conversion.rs:27-35).
"""

from __future__ import annotations

from ..ff.spec import Field
from ..mpc.rep3_scalar import AShare, BShare, HostRng, Rep3Scalar
from .interp import CircomError, PlainDriver

_CACHE_CAP = 1 << 17


class Rep3Driver:
    def __init__(self, proto: Rep3Scalar, field: Field,
                 allow_leaky_logs: bool = False):
        self.pr = proto
        self.p = proto.p
        self.field = field
        self._shift = proto.p // 2 + 1  # signed-compare offset
        self._plain = PlainDriver(field)
        self.allow_leaky_logs = allow_leaky_logs
        self._deferred: list = []  # (diff share, ctx) pending `===` checks
        self._acache: dict = {}  # id(BShare) -> (BShare, AShare)
        self._bcache: dict = {}  # id(AShare) -> (AShare, BShare)
        self._lut = None

    @property
    def lut_provider(self):
        """Oblivious LUT access for shared-index memory ops (reference
        LookupTableProvider, mpc-core/src/lut.rs:12-71)."""
        if self._lut is None:
            from ..mpc.lut import Rep3LookupTableProvider

            self._lut = Rep3LookupTableProvider(self.pr)
        return self._lut

    # -- domain plumbing -----------------------------------------------------
    def is_shared(self, x) -> bool:
        return isinstance(x, (AShare, BShare))

    def _arith(self, x):
        """Public int / AShare passthrough; BShare -> AShare (cached)."""
        if not isinstance(x, BShare):
            return x
        hit = self._acache.get(id(x))
        if hit is not None and hit[0] is x:
            return hit[1]
        nb = x.nbits if x.nbits is not None else self.pr.k
        if nb <= 1:
            r = self.pr.bit_inject(x)
        else:
            y = x
            if nb >= self.p.bit_length():
                # value may exceed p: one conditional subtract reduces it
                y = self.pr._sub_p_cmux_many([x], self.pr.k + 1)[0]
            r = self.pr.b2a(y)
        if len(self._acache) > _CACHE_CAP:
            self._acache.clear()
        self._acache[id(x)] = (x, r)
        return r

    def _bin(self, x) -> BShare:
        """AShare -> BShare (cached). x must be shared.

        Default: A2B Direct (log-depth Kogge-Stone rounds, the LAN
        fit). COSNARKS_A2B=yao routes through the garbled adder-mod-p
        (mpc/yao.py): constant TWO messages per conversion — the
        reference's default — which wins when round latency dominates
        (WAN deployments)."""
        if isinstance(x, BShare):
            return x
        hit = self._bcache.get(id(x))
        if hit is not None and hit[0] is x:
            return hit[1]
        import os

        if os.environ.get("COSNARKS_A2B", "direct").lower() == "yao":
            if not hasattr(self, "_yao"):
                from ..mpc.yao import Rep3Yao

                self._yao = Rep3Yao(self.pr)
            r = self._yao.a2b_many([x])[0]
        else:
            r = self.pr.a2b(x)
        r = BShare(r.a, r.b, self.pr.k)
        if len(self._bcache) > _CACHE_CAP:
            self._bcache.clear()
        self._bcache[id(x)] = (x, r)
        return r

    def norm(self, x):
        """Canonical VM value for signal storage: public int mod p or
        arithmetic share (binary-domain values convert here)."""
        if isinstance(x, BShare):
            return self._arith(x)
        if isinstance(x, AShare):
            return x
        return int(x) % self.p

    def _val(self, x: AShare) -> AShare:
        """Signed-order shift: subtract p/2+1 (mpc/rep3.rs val())."""
        return self.pr.sub_shared_by_public(x, self._shift)

    def _valp(self, c: int) -> int:
        return (c - self._shift) % self.p

    def to_share(self, x) -> AShare:
        if isinstance(x, BShare):
            return self._arith(x)
        return x if isinstance(x, AShare) else self.pr.promote(int(x) % self.p)

    def open(self, x):
        return self.pr.open(self._arith(x)) if self.is_shared(x) else x

    # -- arithmetic ----------------------------------------------------------
    def add(self, a, b):
        a, b = self._arith(a), self._arith(b)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.add(a, b)
        if sa and sb:
            return self.pr.add(a, b)
        return self.pr.add_public(a if sa else b, (b if sa else a) % self.p)

    def sub(self, a, b):
        a, b = self._arith(a), self._arith(b)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.sub(a, b)
        if sa and sb:
            return self.pr.sub(a, b)
        if sa:
            return self.pr.sub_shared_by_public(a, b)
        return self.pr.sub_public_by_shared(a, b)

    def mul(self, a, b):
        a, b = self._arith(a), self._arith(b)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.mul(a, b)
        if sa and sb:
            return self.pr.mul(a, b)
        return self.pr.mul_public(a if sa else b, (b if sa else a) % self.p)

    def mul_many(self, xs, ys):
        """Elementwise products; shared*shared pairs batch into ONE reshare
        round (the gadget hot path: Poseidon2 S-boxes)."""
        xs = [self._arith(x) for x in xs]
        ys = [self._arith(y) for y in ys]
        out: list = [None] * len(xs)
        bx, by, bidx = [], [], []
        for i, (a, b) in enumerate(zip(xs, ys)):
            if isinstance(a, AShare) and isinstance(b, AShare):
                bx.append(a)
                by.append(b)
                bidx.append(i)
            else:
                out[i] = self.mul(a, b)
        if bidx:
            for i, r in zip(bidx, self.pr.mul_many(bx, by)):
                out[i] = r
        return out

    def neg(self, a):
        a = self._arith(a)
        return self.pr.neg(a) if self.is_shared(a) else self._plain.neg(a)

    def div(self, a, b):
        a, b = self._arith(a), self._arith(b)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.div(a, b)
        if not sb:
            if b % self.p == 0:
                raise CircomError("division by zero")
            return self.pr.mul_public(a, pow(b, -1, self.p))
        inv_b = self.pr.inv(b)
        if not sa:
            return self.pr.mul_public(inv_b, a % self.p)
        return self.pr.mul(a, inv_b)

    def idiv(self, a, b):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.idiv(a, b)
        if not sb:
            if b == 0:
                raise CircomError("integer division by zero")
            if b & (b - 1) == 0:  # power of two -> binary shift
                return self.shr(a, b.bit_length() - 1)
            raise CircomError(
                "shared integer division by a non-power-of-2 public divisor "
                "is not implemented (reference uses the Yao path, "
                "circom-mpc-vm/src/mpc/rep3.rs:174)"
            )
        raise CircomError("shared-by-shared integer division unsupported")

    def mod(self, a, b):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.mod(a, b)
        if not sb:
            if b == 0:
                raise CircomError("modulo by zero")
            if b & (b - 1) == 0:
                t = b.bit_length() - 1
                bits = self._bin(a)
                return BShare(bits.a & (b - 1), bits.b & (b - 1), t)
            raise CircomError(
                "shared modulo by a non-power-of-2 public divisor is not "
                "implemented"
            )
        raise CircomError("shared-by-shared modulo unsupported")

    def pow(self, a, b):
        a = self._arith(a)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.pow(a, b)
        if sb:
            raise CircomError("pow with shared exponent unsupported")
        if b == 0:
            return 1
        return self.pr.pow_public(a, b)

    def sqrt(self, a):
        a = self._arith(a)
        if not self.is_shared(a):
            return self._plain.sqrt(a)
        s = self.pr.sqrt(a)
        # normalize to the root in [0, p/2]: 2*is_pos*s - s
        # (reference mpc/rep3.rs:243-258)
        is_pos = self.pr.bit_inject(
            self.pr.unsigned_ge_public_bit(self._val(s), self._valp(0))
        )
        m = self.pr.mul(s, is_pos)
        return self.pr.sub(self.pr.add(m, m), s)

    # -- accelerator ops (reference mpc/rep3.rs:599-650) ---------------------
    def num2bits(self, a, n):
        if not self.is_shared(a):
            return self._plain.num2bits(a, n)
        bits = self._bin(a)
        singles = [
            BShare((bits.a >> i) & 1, (bits.b >> i) & 1, 1) for i in range(n)
        ]
        return self.pr.bit_inject_many(singles)

    def addbits(self, a_bits, b_bits):
        if all(not self.is_shared(x) for x in a_bits + b_bits):
            return self._plain.addbits(a_bits, b_bits)
        n = len(a_bits)
        if n + 1 >= self.pr.k:
            raise CircomError("AddBits width exceeds field capacity")
        va = self.pr.promote(0)
        vb = self.pr.promote(0)
        for x in a_bits:
            va = self.add(self.add(va, va), x)
        for x in b_bits:
            vb = self.add(self.add(vb, vb), x)
        s = self.add(va, vb)
        bits = self._bin(self.to_share(s))
        singles = [
            BShare((bits.a >> i) & 1, (bits.b >> i) & 1, 1)
            for i in range(n + 1)
        ]
        arith = self.pr.bit_inject_many(singles)
        carry = arith[n]
        return list(reversed(arith[:n])), carry

    # -- comparisons (signed circom order) -----------------------------------
    def lt(self, a, b):
        a, b = self._arith(a), self._arith(b)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.lt(a, b)
        one_minus = self.pr.sub_public_by_shared
        if sa and sb:
            return self.pr.lt(self._val(a), self._val(b))
        if sa:  # [a] < b  <=>  not([a] >= b)
            bit = self.pr.unsigned_ge_public_bit(self._val(a), self._valp(b))
            return one_minus(1, self.pr.bit_inject(bit))
        # a < [b]  <=>  not(a >= [b])
        bit = self.pr.unsigned_ge_const_lhs_bit(self._valp(a), self._val(b))
        return one_minus(1, self.pr.bit_inject(bit))

    def le(self, a, b):
        a, b = self._arith(a), self._arith(b)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.le(a, b)
        if sa and sb:
            return self.pr.le(self._val(a), self._val(b))
        if sa:  # [a] <= b  <=>  b >= [a]
            bit = self.pr.unsigned_ge_const_lhs_bit(
                self._valp(b), self._val(a)
            )
            return self.pr.bit_inject(bit)
        # a <= [b]  <=>  [b] >= a
        bit = self.pr.unsigned_ge_public_bit(self._val(b), self._valp(a))
        return self.pr.bit_inject(bit)

    def eq(self, a, b):
        a, b = self._arith(a), self._arith(b)
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.eq(a, b)
        if sa and sb:
            return self.pr.eq(a, b)
        return self.pr.eq_public(a if sa else b, (b if sa else a) % self.p)

    def neq(self, a, b):
        r = self.eq(a, b)
        if self.is_shared(r):
            return self.pr.sub_public_by_shared(1, r)
        return 1 - r

    # -- bit ops (lazy binary domain) ----------------------------------------
    def _nb(self, x: BShare) -> int:
        return x.nbits if x.nbits is not None else self.pr.k

    def band(self, a, b):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.band(a, b)
        if sa and sb:
            xb, yb = self._bin(a), self._bin(b)
            nb = min(self._nb(xb), self._nb(yb))
            r = self.pr.band(xb, yb, nb)
            return BShare(r.a, r.b, nb)
        bits = self._bin(a if sa else b)
        v = (b if sa else a) % self.p
        nb = min(self._nb(bits), v.bit_length())
        return BShare(bits.a & v, bits.b & v, nb)

    def bor(self, a, b):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.bor(a, b)
        if sa and sb:
            xb, yb = self._bin(a), self._bin(b)
            nb = max(self._nb(xb), self._nb(yb))
            r = self.pr.bor(xb, yb, nb)
        else:
            xb = self._bin(a if sa else b)
            v = (b if sa else a) % self.p
            nb = max(self._nb(xb), v.bit_length())
            r = self.pr.bor_public(xb, v)
        return BShare(r.a, r.b, nb)

    def bxor(self, a, b):
        sa, sb = self.is_shared(a), self.is_shared(b)
        if not sa and not sb:
            return self._plain.bxor(a, b)
        if sa and sb:
            xb, yb = self._bin(a), self._bin(b)
            nb = max(self._nb(xb), self._nb(yb))
            return BShare(xb.a ^ yb.a, xb.b ^ yb.b, nb)
        xb = self._bin(a if sa else b)
        v = (b if sa else a) % self.p
        nb = max(self._nb(xb), v.bit_length())
        r = self.pr.bxor_public(xb, v)
        return BShare(r.a, r.b, nb)

    def bnot(self, a):
        if not self.is_shared(a):
            return self._plain.bnot(a)
        nb = self.p.bit_length()
        mask = (1 << nb) - 1
        bits = self._bin(a)
        r = self.pr.bxor_public(bits, mask)
        return BShare(r.a, r.b, nb)

    def shl(self, a, k):
        if self.is_shared(k):
            raise CircomError("shift by shared amount unsupported")
        if not self.is_shared(a):
            return self._plain.shl(a, k)
        if k >= 512:
            return 0
        if isinstance(a, BShare) and self._nb(a) + k < self.p.bit_length():
            return BShare(a.a << k, a.b << k, self._nb(a) + k)
        return self.pr.mul_public(self._arith(a), pow(2, k, self.p))

    def shr(self, a, k):
        if self.is_shared(k):
            raise CircomError("shift by shared amount unsupported")
        if not self.is_shared(a):
            return self._plain.shr(a, k)
        if k >= 512:
            return 0
        bits = self._bin(a)
        nb = max(0, self._nb(bits) - k)
        return BShare(bits.a >> k, bits.b >> k, nb)

    # -- booleans ------------------------------------------------------------
    def is_true(self, a):
        if self.is_shared(a):
            raise CircomError(
                "data-dependent control flow on a shared value (loop "
                "condition or array index); only if/ternary support shared "
                "predicates"
            )
        return a != 0

    def land(self, a, b):
        if not self.is_shared(a) and not self.is_shared(b):
            return self._plain.land(a, b)
        return self.mul(a, b)

    def lor(self, a, b):
        if not self.is_shared(a) and not self.is_shared(b):
            return self._plain.lor(a, b)
        s = self.add(a, b)
        return self.sub(s, self.mul(a, b))

    def lnot(self, a):
        if not self.is_shared(a):
            return self._plain.lnot(a)
        return self.pr.sub_public_by_shared(1, self._arith(a))

    def cmux(self, c, t, f):
        if not self.is_shared(c):
            return t if self.is_true(c) else f
        return self.pr.cmux(self._arith(c), self.to_share(t),
                            self.to_share(f))

    # -- assertions (open only the predicate) --------------------------------
    # `===` checks on shared values are DEFERRED and batch-verified: each
    # diff d_i is masked with an independent shared random r_i and the
    # products are opened fused (one broadcast round for the whole batch).
    # d_i == 0 opens 0; d_i != 0 opens uniform garbage — the same leakage
    # profile as the reference's per-assert is_zero (rep3.rs:541) at a tiny
    # fraction of the rounds (each is_zero costs a full A2B).
    def assert_eq(self, l, r, ctx=""):
        if not self.is_shared(l) and not self.is_shared(r):
            return self._plain.assert_eq(l, r, ctx)
        self._deferred.append((self.pr.sub(self.to_share(l),
                                           self.to_share(r)), ctx))
        if len(self._deferred) >= 8192:
            self.flush_asserts()

    def flush_asserts(self):
        if not self._deferred:
            return
        diffs = [d for d, _ in self._deferred]
        ctxs = [c for _, c in self._deferred]
        self._deferred = []
        rs = [self.pr.rand() for _ in diffs]
        vals = self.pr.mul_open_many(diffs, rs)
        import numpy as _np

        bad = [ctxs[i] for i, v in enumerate(vals) if bool(_np.any(v != 0))]
        if bad:
            raise CircomError(
                f"constraint violated{bad[0]} (on shared values; "
                f"{len(bad)} of {len(vals)} checks in batch failed)"
            )

    def assert_true(self, c, ctx=""):
        if not self.is_shared(c):
            return self._plain.assert_true(c, ctx)
        import numpy as _np

        # is_zero_open returns a bool (scalar driver) or a bool vector
        # (batched driver); any zero lane fails the assert
        if bool(_np.any(self.pr.is_zero_open(self._arith(c)))):
            raise CircomError(f"assert failed{ctx} (on shared value)")


def setup_rep3_vm(net, field: Field, party_rng=None, seed: bytes | None = None):
    """Build a Rep3 VM driver over a network: 256-bit PRF key exchange (one
    round, rep3.rs:71-110) unless an existing device PartyRng is supplied —
    then the host streams derive from the same key material."""
    if party_rng is not None:
        rng = HostRng.from_party_rng(party_rng)
    else:
        import os

        if seed is None:
            seed = os.urandom(32)
        key_next = bytes(net.reshare_backward(seed))
        rng = HostRng(seed, key_next)
    proto = Rep3Scalar(net, rng, field.p)
    return Rep3Driver(proto, field)
