"""Port of `cosnarks_tpu.mpc.rep3_ring`: host Python, copied unchanged.

Rep3 over power-of-two rings Z_2^k + the OHV / LUT / oblivious-sort
gadgets built on it.

Counterpart of the reference's rep3_ring protocol family
(mpc-core/src/protocols/rep3_ring/{arithmetic,binary,conversion}.rs and
gadgets/{ohv,lut_field,sort}.rs). Ring shares power the gadgets where a
full prime-field element is waste: one-hot-vector indices (k <= 32 bits),
radix-sort destination ranks (u32), small integer arithmetic. Arithmetic
mod 2^k is a bitmask instead of a Barrett/Montgomery reduce, and A2B needs
no conditional subtract-p — the Kogge-Stone adder's natural 2^k wrap IS
the ring reduction.

Like rep3_scalar.py this runs host-side on python ints: every op here is
round-latency-bound VM/solver plumbing, not bulk field work (which lives
on-device in mpc/rep3.py). Shares are replicated (a, b) = (x_i, x_{i+1})
in the same convention as rep3_scalar.

Gadgets (re-derived, not transcribed):
 - ohv / rand_ohv: one-hot vector from a binary-shared index, Protocol 5
   of eprint 2024/1317 (rep3_ring/gadgets/ohv.rs). Ours builds the vector
   iteratively LSB-up with the whole vector PACKED into one big int per
   share component, so each doubling level is a single 1-element reshare
   (the reference packs into u8..u128 chunks; python bigints remove the
   chunking).
 - read_public_lut / read_shared_lut / write_lut: oblivious lookup-table
   access (gadgets/lut_field.rs, Protocol 4 of eprint 2024/1317).
 - radix_sort_fields: oblivious LSD radix sort via secret-shared
   destination ranks (gadgets/sort.rs, eprint 2019/695). The 3-party
   shuffle is our own leg-based formulation: the composite permutation is
   three pairwise-known permutations applied in sequence; per leg the
   non-knowing party splits its additive share into fresh-masked halves
   for the two knowers, who locally add + permute. Same trust structure
   (each party never learns the leg it doesn't hold), simpler dataflow
   than the reference's alpha/beta/gamma pipeline.
"""

from __future__ import annotations

import dataclasses

from .rep3_scalar import AShare, BShare, HostRng, Rep3Scalar


@dataclasses.dataclass(frozen=True, slots=True)
class RingShare:
    """Replicated share (a, b) of a value in Z_2^k (k carried by the
    protocol context, not the share)."""

    a: int
    b: int


class Rep3Ring:
    """One party's Z_2^k protocol context. Shares the network and the
    correlated-randomness streams with the field protocol; `k` is the ring
    bit width (reference IntRing2k: 1 (Bit), 8, 16, 32, 64, 128 — any
    width works here)."""

    def __init__(self, net, rng: HostRng, k: int):
        self.net = net
        self.id = net.id
        self.rng = rng
        self.k = k
        self.mask = (1 << k) - 1
        # binary-domain helpers (band_many / Kogge-Stone) are width-
        # parameterized and modulus-free; borrow them from the scalar
        # protocol rather than re-implementing
        self._b = Rep3Scalar(net, rng, (1 << k) + 1)

    # -- arithmetic mod 2^k (rep3_ring/arithmetic.rs) ------------------------
    def add(self, x: RingShare, y: RingShare) -> RingShare:
        m = self.mask
        return RingShare((x.a + y.a) & m, (x.b + y.b) & m)

    def sub(self, x: RingShare, y: RingShare) -> RingShare:
        m = self.mask
        return RingShare((x.a - y.a) & m, (x.b - y.b) & m)

    def neg(self, x: RingShare) -> RingShare:
        m = self.mask
        return RingShare(-x.a & m, -x.b & m)

    def add_public(self, x: RingShare, v: int) -> RingShare:
        m = self.mask
        if self.id == 0:
            return RingShare((x.a + v) & m, x.b)
        if self.id == 2:
            return RingShare(x.a, (x.b + v) & m)
        return RingShare(x.a, x.b)

    def mul_public(self, x: RingShare, v: int) -> RingShare:
        m = self.mask
        return RingShare(x.a * v & m, x.b * v & m)

    def promote(self, v: int) -> RingShare:
        if self.id == 0:
            return RingShare(v & self.mask, 0)
        if self.id == 2:
            return RingShare(0, v & self.mask)
        return RingShare(0, 0)

    def mul_many(self, xs, ys) -> list[RingShare]:
        m1 = self.mask + 1
        local = [
            (x.a * y.a + x.a * y.b + x.b * y.a + self.rng.zero_add(m1))
            & self.mask
            for x, y in zip(xs, ys)
        ]
        other = self.net.reshare_backward(local)
        return [RingShare(a, b & self.mask) for a, b in zip(local, other)]

    def open_many(self, xs) -> list[int]:
        other = self.net.reshare_backward([x.b for x in xs])
        return [(x.a + x.b + c) & self.mask for x, c in zip(xs, other)]

    def rand_share(self) -> RingShare:
        m, n = self.rng.pair(b"rr")
        return RingShare(m & self.mask, n & self.mask)

    @staticmethod
    def share(v: int, k: int) -> list[RingShare]:
        import secrets

        m = (1 << k) - 1
        x0, x1 = secrets.randbits(k), secrets.randbits(k)
        x2 = (v - x0 - x1) & m
        xs = [x0, x1, x2]
        return [RingShare(xs[i], xs[(i + 1) % 3]) for i in range(3)]

    @staticmethod
    def combine(shares: list[RingShare], k: int) -> int:
        return (shares[0].a + shares[1].a + shares[2].a) & ((1 << k) - 1)

    # -- binary domain over k bits (rep3_ring/binary.rs) ---------------------
    def rand_bits(self) -> BShare:
        m, n = self.rng.pair(b"rb")
        return BShare(m & self.mask, n & self.mask, self.k)

    def open_bits(self, x: BShare) -> int:
        other = self.net.reshare_backward([x.b])
        return (x.a ^ x.b ^ other[0]) & self.mask

    # -- conversions (rep3_ring/conversion.rs) -------------------------------
    def a2b_many(self, xs: list[RingShare]) -> list[BShare]:
        """Ring arithmetic -> binary: party 0 xor-shares x_0 + x_1, the
        others already hold x_2 in replicated components, one k-bit binary
        add recombines (the 2^k wrap needs no conditional subtract)."""
        k = self.k
        contribs, x2s = [], []
        for x in xs:
            r = self.rng.zero_xor(k)
            if self.id == 0:
                contribs.append(((x.a + x.b) & self.mask) ^ r)
                x2s.append(BShare(0, 0))
            elif self.id == 1:
                contribs.append(r)
                x2s.append(BShare(0, x.b))
            else:
                contribs.append(r)
                x2s.append(BShare(x.a, 0))
        other = self.net.reshare_backward(contribs)
        x01s = [BShare(a, b) for a, b in zip(contribs, other)]
        out = self._b.binary_add_many(x01s, x2s, k)
        return [BShare(s.a & self.mask, s.b & self.mask, k) for s in out]

    def b2a_many(self, xs: list[BShare]) -> list[RingShare]:
        """Binary -> ring arithmetic via masked open of z = x + r2 + r3
        (structure of rep3/conversion.rs:149-297 minus the mod-p care)."""
        k, m = self.k, self.mask
        contribs, parts = [], []
        for _ in xs:
            r = self.rng.zero_xor(k)
            if self.id == 0:
                r2 = self.rng.solo_next(m + 1, b"rc01")
                contribs.append(r)
                parts.append((None, -r2 & m))
            elif self.id == 1:
                r2 = self.rng.solo_mine(m + 1, b"rc01")
                r3 = self.rng.solo_next(m + 1, b"rc12")
                contribs.append(((r2 + r3) & m) ^ r)
                parts.append((-r2 & m, -r3 & m))
            else:
                r3 = self.rng.solo_mine(m + 1, b"rc12")
                contribs.append(r)
                parts.append((-r3 & m, None))
        other = self.net.reshare_backward(contribs)
        ys = [BShare(a, b) for a, b in zip(contribs, other)]
        zs = self._b.binary_add_many(xs, ys, k)
        zs = [BShare(z.a & m, z.b & m) for z in zs]
        if self.id == 0:
            self.net.send(2, [z.b for z in zs])
            rcv = self.net.recv(1)
            return [RingShare((z.a ^ z.b ^ c) & m, b)
                    for z, c, (_, b) in zip(zs, rcv, parts)]
        if self.id == 1:
            self.net.send(0, [z.b for z in zs])
            return [RingShare(a, b) for a, b in parts]
        rcv = self.net.recv(0)
        return [RingShare(a, (z.a ^ z.b ^ c) & m)
                for z, c, (a, _) in zip(zs, rcv, parts)]

    def bit_inject_many(self, xs: list[BShare]) -> list[RingShare]:
        """Single-bit binary share -> ring arithmetic share of the bit
        (same arithmetic-xor construction as the field version,
        rep3/conversion.rs:300-433, with the 2^k wrap)."""
        m1 = self.mask + 1
        m = self.mask
        if self.id == 0:
            outs = []
            for x in xs:
                w = (x.a ^ x.b) & 1
                outs.append((self.rng.zero_add(m1) + w) & m)
            self.net.send(2, outs)
            rcv = self.net.recv(1)
            return [RingShare(a, b) for a, b in zip(outs, rcv)]
        if self.id == 1:
            outs = []
            for x in xs:
                y = x.b & 1
                z1 = self.rng.zero_add(m1)
                outs.append((z1 + y * (1 - 2 * z1)) & m)
            self.net.send(0, outs)
            rcv = self.net.recv(2)
            return [RingShare(a, b) for a, b in zip(outs, rcv)]
        rcv = self.net.recv(0)
        outs = []
        for x, r0 in zip(xs, rcv):
            y = x.a & 1
            z2 = self.rng.zero_add(m1)
            outs.append((z2 - 2 * (y * (r0 + z2))) & m)
        self.net.send(1, outs)
        return [RingShare(a, b) for a, b in zip(outs, rcv)]


# =============================================================================
# OHV gadget (rep3_ring/gadgets/ohv.rs; Protocol 5 of eprint 2024/1317)
# =============================================================================

def ohv_from_bits(ring: Rep3Ring, bits: BShare, k: int) -> BShare:
    """One-hot vector of the k-bit binary-shared index `bits`, PACKED:
    the returned BShare's bit j (of 2^k) is the share of [j == index].

    Built LSB-up: e^(1) = [~v0, v0]; per extra bit v_t one packed AND
    (g = e & v_t, a single 1-element reshare of a 2^t-bit int) extends via
    e^(t+1) = (e ^ g) | (g << 2^t). k-1 rounds total, like the
    reference's recursive pack_and (ohv.rs:46-117)."""
    v0a, v0b = bits.a & 1, bits.b & 1
    # e = [~v0, v0]: bit0 = 1 ^ v0 (public-xor on component 0), bit1 = v0
    ea = (v0a << 1) | v0a
    eb = (v0b << 1) | v0b
    if ring.id == 0:
        ea ^= 1
    elif ring.id == 2:
        eb ^= 1
    for t in range(1, k):
        width = 1 << t
        va, vb = (bits.a >> t) & 1, (bits.b >> t) & 1
        r = ring.rng.zero_xor(width)
        ga = ((ea * va) ^ (ea * vb) ^ (eb * va) ^ r)
        gb = ring.net.reshare_backward([ga])[0]
        ea = (ea ^ ga) | (ga << width)
        eb = (eb ^ gb) | (gb << width)
    return BShare(ea, eb, 1 << k)


def ohv_from_bits_many(ring: Rep3Ring, bits_list: list[BShare],
                       k: int) -> list[BShare]:
    """Batched ohv_from_bits: each doubling level reshapes into ONE
    reshare round carrying every index's packed AND (the batching the
    reference gets from vectorized gadget entry points)."""
    eas, ebs = [], []
    for bits in bits_list:
        v0a, v0b = bits.a & 1, bits.b & 1
        ea = (v0a << 1) | v0a
        eb = (v0b << 1) | v0b
        if ring.id == 0:
            ea ^= 1
        elif ring.id == 2:
            eb ^= 1
        eas.append(ea)
        ebs.append(eb)
    for t in range(1, k):
        width = 1 << t
        gas = []
        for i, bits in enumerate(bits_list):
            va, vb = (bits.a >> t) & 1, (bits.b >> t) & 1
            r = ring.rng.zero_xor(width)
            gas.append((eas[i] * va) ^ (eas[i] * vb) ^ (ebs[i] * va) ^ r)
        gbs = ring.net.reshare_backward(gas)
        for i in range(len(bits_list)):
            eas[i] = (eas[i] ^ gas[i]) | (gas[i] << width)
            ebs[i] = (ebs[i] ^ gbs[i]) | (gbs[i] << width)
    return [BShare(a, b, 1 << k) for a, b in zip(eas, ebs)]


def read_public_lut_bits_many(ring: Rep3Ring, fp, lut: list[int],
                              idx_bits: list[BShare],
                              value_bits: int) -> list[BShare]:
    """Batched public-table reads returning BINARY shares of the values
    (for consumers that keep working in the XOR domain, e.g. the AES
    S-box): one batched rand_ohv + ONE open round for all indices, local
    XOR gathers (lut_field.rs:17-56 without the trailing B2A)."""
    n = len(lut)
    k = max(1, (n - 1).bit_length())
    kmask = (1 << k) - 1
    m, nn = ring.rng.pair(b"ohvb")
    rs = []
    for i in range(len(idx_bits)):
        # independent per-read random offsets from one vector draw
        ra = (m >> (k * i)) & kmask
        rb = (nn >> (k * i)) & kmask
        rs.append(BShare(ra, rb, k))
    if k * len(idx_bits) > 500:  # beyond one 512-bit draw: draw per read
        rs = [BShare(*(v & kmask for v in ring.rng.pair(b"ohvb%d" % i)), k)
              for i in range(len(idx_bits))]
    es = ohv_from_bits_many(ring, rs, k)
    masked = [BShare((r.a ^ ib.a) & kmask, (r.b ^ ib.b) & kmask)
              for r, ib in zip(rs, idx_bits)]
    other = ring.net.reshare_backward([x.b for x in masked])
    cs = [(x.a ^ x.b ^ c) & kmask for x, c in zip(masked, other)]
    out = []
    for e, c in zip(es, cs):
        ta = tb = 0
        for j in range(1 << k):
            idx = j ^ c
            if idx >= n:
                continue
            if (e.a >> j) & 1:
                ta ^= lut[idx]
            if (e.b >> j) & 1:
                tb ^= lut[idx]
        out.append(BShare(ta, tb, value_bits))
    return out


def read_public_luts_many(ring: Rep3Ring, fp, luts: list[tuple],
                          idx_bits: list[BShare], k: int):
    """Batched multi-table reads with ARITHMETIC outputs: read i gathers
    every table in luts[i] (e.g. a point's x and y columns) under ONE
    one-hot vector; all OHVs and the index opens batch into shared
    rounds, and the binary->arithmetic conversions of every output batch
    into one pass (reference read_multiple_public_lut_low_depth,
    rep3_ring/gadgets/lut_field.rs:136-213)."""
    kmask = (1 << k) - 1
    rs = [BShare(*(v & kmask for v in ring.rng.pair(b"ohvm%d" % i)), k)
          for i in range(len(idx_bits))]
    es = ohv_from_bits_many(ring, rs, k)
    masked = [BShare((r.a ^ ib.a) & kmask, (r.b ^ ib.b) & kmask)
              for r, ib in zip(rs, idx_bits)]
    other = ring.net.reshare_backward([x.b for x in masked])
    cs = [(x.a ^ x.b ^ c) & kmask for x, c in zip(masked, other)]
    flat = []
    for (e, c), tables in zip(zip(es, cs), luts):
        for lut in tables:
            n = len(lut)
            ta = tb = 0
            for j in range(1 << k):
                idx = j ^ c
                if idx >= n:
                    continue
                if (e.a >> j) & 1:
                    ta ^= lut[idx]
                if (e.b >> j) & 1:
                    tb ^= lut[idx]
            flat.append(BShare(ta, tb, fp.k))
    flat = fp._sub_p_cmux_many(flat, fp.k + 1)
    arith = fp.b2a_many(flat)
    out, pos = [], 0
    for tables in luts:
        out.append(tuple(arith[pos:pos + len(tables)]))
        pos += len(tables)
    return out


def rand_ohv(ring: Rep3Ring, k: int) -> tuple[BShare, BShare]:
    """(r, e): r = binary share of a random k-bit index, e = packed OHV
    of r (ohv.rs:20-41)."""
    m, n = ring.rng.pair(b"ohv")
    mask = (1 << k) - 1
    r = BShare(m & mask, n & mask, k)
    return r, ohv_from_bits(ring, r, k)


def unpack_bits(e: BShare, n: int) -> list[BShare]:
    return [BShare((e.a >> j) & 1, (e.b >> j) & 1, 1) for j in range(n)]


def _ohv_range_err(e: BShare, badmask: int) -> BShare:
    """1-bit share of "the OHV selects a slot outside the table".

    A one-hot vector has at most ONE set bit in total, so OR over the
    masked-out positions equals XOR over them — and XOR of XOR-shared bits
    is a LOCAL parity per replicated half. Opening the single resulting bit
    reveals only the in-range/out-of-range predicate (which is a protocol
    error either way), never the index."""
    pa = bin(e.a & badmask).count("1") & 1
    pb = bin(e.b & badmask).count("1") & 1
    return BShare(pa, pb, 1)


def _check_ohv_range(ring: Rep3Ring, e: BShare, badmask: int, what: str):
    if badmask == 0:
        return
    err = _ohv_range_err(e, badmask)
    if ring.open_bits(BShare(err.a, err.b, ring.k)) & 1:
        raise ValueError(
            f"{what}: shared index selects a slot outside the table "
            f"(index >= table length; non-power-of-two tables reject "
            f"out-of-range indices instead of returning a zero share)")


# =============================================================================
# LUT gadgets (rep3_ring/gadgets/lut_field.rs; Protocol 4 of 2024/1317)
# =============================================================================

def _dot_open_masked(fp: Rep3Scalar, es, ls):
    """sum_i e_i * l_i as ONE masked reshare (degree-2 local cross terms
    plus a fresh zero share), returning a replicated field share."""
    p = fp.p
    acc = fp.rng.zero_add(p)
    for e, l in zip(es, ls):
        acc = (acc + e.a * l.a + e.a * l.b + e.b * l.a) % p
    other = fp.net.reshare_backward([acc])
    return AShare(acc, other[0] % p)


def read_public_lut(ring: Rep3Ring, fp: Rep3Scalar, lut: list[int],
                    index_bits: BShare) -> AShare:
    """lut[index] for a PUBLIC table and a binary-shared ring index
    (lut_field.rs:17-56): random OHV at a random offset r, open c = r ^
    index, XOR-accumulate lut[j ^ c] under the OHV bits — all local after
    the one opened value — then one binary->arithmetic conversion."""
    n = len(lut)
    k = max(1, (n - 1).bit_length())
    r, e = rand_ohv(ring, k)
    kmask = (1 << k) - 1
    c = ring.open_bits(BShare((r.a ^ index_bits.a) & kmask,
                              (r.b ^ index_bits.b) & kmask)) & kmask
    badmask = 0
    for j in range(1 << k):
        if (j ^ c) >= n:
            badmask |= 1 << j
    _check_ohv_range(ring, e, badmask, "read_public_lut")
    ta = tb = 0
    for j in range(1 << k):
        idx = j ^ c
        if idx >= n:
            continue
        if (e.a >> j) & 1:
            ta ^= lut[idx]
        if (e.b >> j) & 1:
            tb ^= lut[idx]
    # XOR of field elements can exceed p: full-width conditional-subtract
    # + B2A through the field protocol
    t = BShare(ta, tb, fp.k)
    t = fp._sub_p_cmux_many([t], fp.k + 1)[0]
    return fp.b2a(t)


def read_shared_lut(ring: Rep3Ring, fp: Rep3Scalar,
                    lut: list[AShare], index_bits: BShare) -> AShare:
    """lut[index] for a SECRET-SHARED table (lut_field.rs:215-240): OHV of
    the index itself, bit-inject to field shares, one masked inner-product
    reshare."""
    n = len(lut)
    k = max(1, (n - 1).bit_length())
    e = ohv_from_bits(ring, index_bits, k)
    _check_ohv_range(ring, e, ((1 << (1 << k)) - 1) ^ ((1 << n) - 1),
                     "read_shared_lut")
    es = fp.bit_inject_many(unpack_bits(e, n))
    return _dot_open_masked(fp, es, lut)


def write_lut(ring: Rep3Ring, fp: Rep3Scalar, value: AShare,
              lut: list[AShare], index_bits: BShare) -> list[AShare]:
    """lut[index] = value on a secret-shared table (lut_field.rs:242-283):
    new_i = l_i + e_i * (value - l_i), one batched masked reshare."""
    n = len(lut)
    k = max(1, (n - 1).bit_length())
    e = ohv_from_bits(ring, index_bits, k)
    _check_ohv_range(ring, e, ((1 << (1 << k)) - 1) ^ ((1 << n) - 1),
                     "write_lut")
    es = fp.bit_inject_many(unpack_bits(e, n))
    p = fp.p
    local = []
    for ei, li in zip(es, lut):
        da, db = (value.a - li.a) % p, (value.b - li.b) % p
        local.append((ei.a * da + ei.a * db + ei.b * da + li.a
                      + fp.rng.zero_add(p)) % p)
    other = fp.net.reshare_backward(local)
    return [AShare(a, b % p) for a, b in zip(local, other)]


# =============================================================================
# Oblivious shuffle + radix sort (rep3_ring/gadgets/sort.rs; eprint 2019/695)
# =============================================================================

_PERM_K = 32  # destination ranks as u32 ring shares (reference PermRing)


def _leg_perm(rng: HostRng, n: int, leg: int, my_id: int,
              tag: int) -> list[int] | None:
    """Permutation for leg j (known to parties j and j+1): Fisher-Yates
    seeded from the pairwise stream those two share. Returns None for the
    non-knowing party. `tag` domain-separates independent shuffles."""
    if my_id == leg:
        draw = lambda i: rng.solo_next((1 << 64), b"shf%d-%d" % (tag, i))
    elif my_id == (leg + 1) % 3:
        draw = lambda i: rng.solo_mine((1 << 64), b"shf%d-%d" % (tag, i))
    else:
        # keep counter streams aligned: nothing drawn for foreign legs
        return None
    perm = list(range(n))
    for i in range(n - 1, 0, -1):
        j = draw(n - 1 - i) % (i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    return perm


class _Shuffler:
    """One jointly-sampled secret permutation Pi = P2 . P1 . P0 (leg j
    known to parties j, j+1) with apply / inverse-apply over additively
    lifted replicated shares of any modulus. Leg protocol: the party NOT
    holding p_j splits its additive share x into u + (x - u) with fresh u
    and sends one half to each knower, who add and locally permute; after
    the legs a zero-share re-randomized reshare restores replication."""

    def __init__(self, proto, n: int):
        self.pr = proto
        self.n = n
        # per-protocol-instance tag (protocol lineage is identical across
        # parties, so tags agree; a process-global counter would not —
        # parties run as threads in tests)
        tag = getattr(proto, "_shuffle_tag", 0)
        proto._shuffle_tag = tag + 1
        self.legs = [_leg_perm(proto.rng, n, j, proto.id, tag)
                     for j in range(3)]

    def _run(self, vals: list[int], mod: int, legs, invert: bool):
        pr, n = self.pr, self.n
        me = pr.id
        x = [v % mod for v in vals]
        for j, perm in legs:
            if perm is None:  # non-knower: split and retire this share
                import secrets

                # masks must be PRIVATE to this party (every rng stream is
                # pairwise-shared, i.e. known to one of the receivers)
                u = [secrets.randbelow(mod) for _ in range(n)]
                w = [(a - b) % mod for a, b in zip(x, u)]
                self._send_split(j, u, w)
                x = [0] * n
            else:
                r = self._recv_split(j)
                x = [(a + b) % mod for a, b in zip(x, r)]
                if invert:
                    y = [0] * n
                    for t in range(n):
                        y[perm[t]] = x[t]
                    x = y
                else:
                    x = [x[perm[t]] for t in range(n)]
        return x

    def _send_split(self, leg, u, w):
        # knowers of leg j are j and j+1
        self.pr.net.send(leg, u)
        self.pr.net.send((leg + 1) % 3, w)

    def _recv_split(self, leg):
        return self.pr.net.recv((leg + 2) % 3)

    def _finish(self, x: list[int], mod: int):
        pr = self.pr
        x = [(v + pr.rng.zero_add(mod)) % mod for v in x]
        other = pr.net.reshare_backward(x)
        return x, [v % mod for v in other]

    def apply(self, shares, mod: int, mk):
        """Pi-shuffle replicated shares; mk(a, b) builds the share type."""
        legs = [(j, self.legs[j]) for j in range(3)]
        x = self._run([s.a for s in shares], mod, legs, invert=False)
        a, b = self._finish(x, mod)
        return [mk(ai, bi) for ai, bi in zip(a, b)]

    def apply_inv(self, shares, mod: int, mk):
        legs = [(j, self.legs[j]) for j in (2, 1, 0)]
        x = self._run([s.a for s in shares], mod, legs, invert=True)
        a, b = self._finish(x, mod)
        return [mk(ai, bi) for ai, bi in zip(a, b)]

    def apply_reveal(self, shares, mod: int) -> list[int]:
        out = self.apply(shares, mod, lambda a, b: RingShare(a, b))
        other = self.pr.net.reshare_backward([s.b for s in out])
        return [(s.a + s.b + c) % mod for s, c in zip(out, other)]


def _gen_bit_perm(ring: Rep3Ring, bits: list[RingShare]) -> list[RingShare]:
    """Destination ranks (1-indexed) of a stable sort by one shared bit
    (sort.rs:255-322): f0 = 1-b, f1 = b; s0/s1 = running counts with all
    zeros ranked before all ones; rank = f0*s0 + f1*s1 (one mul round)."""
    one = ring.promote(1)
    f0 = [ring.sub(one, b) for b in bits]
    f1 = bits
    s = ring.promote(0)
    s0, s1 = [], []
    for f in f0:
        s = ring.add(s, f)
        s0.append(s)
    for f in f1:
        s = ring.add(s, f)
        s1.append(s)
    prods = ring.mul_many(f0 + f1, s0 + s1)
    n = len(bits)
    return [ring.add(prods[i], prods[n + i]) for i in range(n)]


def _apply_inv_perm(ring: Rep3Ring, rho: list[RingShare], payload,
                    mod: int, mk):
    """Scatter payload[i] to rank rho[i] (1-indexed) without revealing
    rho (sort.rs:324-356): shuffle both by a fresh random Pi, open the
    shuffled ranks, scatter locally."""
    sh = _Shuffler(ring, len(rho))
    opened = sh.apply_reveal(rho, ring.mask + 1)
    moved = sh.apply(payload, mod, mk)
    out = [None] * len(rho)
    for pos, v in zip(opened, moved):
        out[(pos - 1) & ring.mask] = v
    return out


def compose_ranks(ring: Rep3Ring, sigma, phi):
    """out[i] = phi[sigma[i]-1]: shuffle sigma with a fresh Pi and open;
    gather phi (unshuffled, still secret-shared) at the opened ranks in
    shuffled order; un-shuffle the gathered list back (sort.rs:388-411)."""
    sh = _Shuffler(ring, len(sigma))
    opened = sh.apply_reveal(sigma, ring.mask + 1)
    gathered = [phi[(pos - 1) & ring.mask] for pos in opened]
    return sh.apply_inv(gathered, ring.mask + 1,
                        lambda a, b: RingShare(a, b))


def radix_sort_fields(fp: Rep3Scalar, ring: Rep3Ring,
                      priv_inputs: list[AShare], pub_inputs: list[int],
                      bitsize: int) -> list[AShare]:
    """Ascending oblivious LSD radix sort on the low `bitsize` bits
    (sort.rs:27-93). Shared inputs order before public inputs on entry;
    the returned list is fully secret-shared and sorted."""
    if ring.k != _PERM_K:
        raise ValueError("rank ring must be %d bits" % _PERM_K)
    n = len(priv_inputs) + len(pub_inputs)
    if n == 0:
        return []
    priv_bits = fp.a2b_many(priv_inputs) if priv_inputs else []

    def bit_ring_shares(t: int) -> list[RingShare]:
        singles = [BShare((x.a >> t) & 1, (x.b >> t) & 1, 1)
                   for x in priv_bits]
        inj = ring.bit_inject_many(singles) if singles else []
        pubs = [ring.promote((v >> t) & 1) for v in pub_inputs]
        return inj + pubs

    perm = _gen_bit_perm(ring, bit_ring_shares(0))
    for t in range(1, bitsize):
        bits_t = bit_ring_shares(t)
        permuted = _apply_inv_perm(ring, perm, bits_t, ring.mask + 1,
                                   lambda a, b: RingShare(a, b))
        perm_t = _gen_bit_perm(ring, permuted)
        perm = compose_ranks(ring, perm, perm_t)

    payload = list(priv_inputs) + [fp.promote(v) for v in pub_inputs]
    return _apply_inv_perm(ring, perm, payload, fp.p,
                           lambda a, b: AShare(a, b))
