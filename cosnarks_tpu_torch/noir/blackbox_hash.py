"""Port of `cosnarks_tpu.noir.blackbox_hash`: host Python, copied unchanged.

SHA-256 compression, Blake2s, Blake3 and AES-128 for the ACVM solver.

Counterparts of the reference blackbox implementations
(co-noir/co-acvm/src/solver/blackbox_solver.rs:432-523 dispatch;
mpc-core rep3 hash impls). The ARX hash functions are written once over a
small word-op interface:

- PlainWordOps: python ints (the plain driver / PlainAcvmSolver path)
- Rep3WordOps: 32-bit binary shares over the host Rep3 protocol — xor /
  rotate / shift are local, AND is one batched network round, addition is
  a batched Kogge-Stone adder (mpc/rep3_scalar.py binary domain) — the
  same substrate the circom VM's SHA-256 KATs run on.

AES-128 (CBC + PKCS7, matching the acvm blackbox semantics) is plain-only
for now: its S-boxes need the GC/LUT machinery (tracked for the rep3_ring
stage).

Independent word operations are list-batched so a Blake G-round costs one
network round per AND level rather than per word.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF


class PlainWordOps:
    def xor(self, xs, ys):
        return [x ^ y for x, y in zip(xs, ys)]

    def xor_const(self, xs, cs):
        return [x ^ c for x, c in zip(xs, cs)]

    def and_(self, xs, ys):
        return [x & y for x, y in zip(xs, ys)]

    def not_(self, xs):
        return [x ^ M32 for x in xs]

    def add(self, xs, ys):
        return [(x + y) & M32 for x, y in zip(xs, ys)]

    def add_const(self, xs, cs):
        return [(x + c) & M32 for x, c in zip(xs, cs)]

    def rotr(self, xs, n):
        return [((x >> n) | (x << (32 - n))) & M32 for x in xs]

    def shr(self, xs, n):
        return [x >> n for x in xs]

    def const(self, v):
        return v & M32


class Rep3WordOps:
    """Words are BShare with nbits=32 (mpc/rep3_scalar.py)."""

    def __init__(self, proto):
        from ..mpc.rep3_scalar import BShare

        self.pr = proto
        self._B = BShare

    def _w(self, x):
        return self._B(x.a & M32, x.b & M32, 32)

    def xor(self, xs, ys):
        return [self._w(self.pr.bxor(x, y)) for x, y in zip(xs, ys)]

    def xor_const(self, xs, cs):
        return [self._w(self.pr.bxor_public(x, c)) for x, c in zip(xs, cs)]

    def and_(self, xs, ys):
        return [self._w(v) for v in self.pr.band_many(xs, ys, 32)]

    def not_(self, xs):
        return [self._w(self.pr.bxor_public(x, M32)) for x in xs]

    def add(self, xs, ys):
        return [self._w(v)
                for v in self.pr.binary_add_many(xs, ys, 32)]

    def add_const(self, xs, cs):
        consts = [self.pr.bpromote(c & M32) for c in cs]
        return self.add(xs, consts)

    def rotr(self, xs, n):
        out = []
        for x in xs:
            lo = self.pr.bshift_r(x, n)
            hi = self.pr.bshift_l(x, 32 - n)
            out.append(self._w(self.pr.bxor(lo, hi)))
        return out

    def shr(self, xs, n):
        return [self._w(self.pr.bshift_r(x, n)) for x in xs]

    def const(self, v):
        return self.pr.bpromote(v & M32)


# -- SHA-256 compression -----------------------------------------------------

_SHA_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]


def sha256_compression(ops, state, message):
    """One SHA-256 compression: 8 state words + 16 message words -> 8
    words (acvm Sha256Compression semantics: NO feed-forward constants
    beyond adding the input state)."""
    w = list(message)
    for i in range(16, 64):
        s0a = ops.rotr([w[i - 15]], 7)
        s0b = ops.rotr([w[i - 15]], 18)
        s0c = ops.shr([w[i - 15]], 3)
        s0 = ops.xor(ops.xor(s0a, s0b), s0c)[0]
        s1a = ops.rotr([w[i - 2]], 17)
        s1b = ops.rotr([w[i - 2]], 19)
        s1c = ops.shr([w[i - 2]], 10)
        s1 = ops.xor(ops.xor(s1a, s1b), s1c)[0]
        t = ops.add([w[i - 16]], [s0])
        t = ops.add(t, [w[i - 7]])
        w.append(ops.add(t, [s1])[0])

    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = ops.xor(ops.xor(ops.rotr([e], 6), ops.rotr([e], 11)),
                     ops.rotr([e], 25))[0]
        # ch = g ^ (e & (f ^ g)) — one AND round
        ch = ops.xor([g], ops.and_([e], ops.xor([f], [g])))[0]
        t1 = ops.add([h], [s1])
        t1 = ops.add_const(t1, [_SHA_K[i]])
        t1 = ops.add(t1, [ch])
        t1 = ops.add(t1, [w[i]])[0]
        s0 = ops.xor(ops.xor(ops.rotr([a], 2), ops.rotr([a], 13)),
                     ops.rotr([a], 22))[0]
        # maj = (a & b) ^ (c & (a ^ b)) — batch the two ANDs
        axb = ops.xor([a], [b])[0]
        ands = ops.and_([a, c], [b, axb])
        maj = ops.xor([ands[0]], [ands[1]])[0]
        t2 = ops.add([s0], [maj])[0]
        h, g, f = g, f, e
        e = ops.add([d], [t1])[0]
        d, c, b = c, b, a
        a = ops.add([t1], [t2])[0]

    out = [a, b, c, d, e, f, g, h]
    return ops.add(out, list(state))


# -- Blake2s ------------------------------------------------------------------

_B2S_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
           0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
_B2S_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _blake_quarter(ops, a, b, c, d, mx, my, rots):
    """One G quarter-round, vectorized over 4 independent lanes."""
    r0, r1, r2, r3 = rots
    a = ops.add(ops.add(a, b), mx)
    d = ops.rotr(ops.xor(d, a), r0)
    c = ops.add(c, d)
    b = ops.rotr(ops.xor(b, c), r1)
    a = ops.add(ops.add(a, b), my)
    d = ops.rotr(ops.xor(d, a), r2)
    c = ops.add(c, d)
    b = ops.rotr(ops.xor(b, c), r3)
    return a, b, c, d


def _blake2s_round(ops, v, m, sigma):
    idx = sigma
    cols = ([v[0], v[1], v[2], v[3]], [v[4], v[5], v[6], v[7]],
            [v[8], v[9], v[10], v[11]], [v[12], v[13], v[14], v[15]])
    mx = [m[idx[2 * i]] for i in range(4)]
    my = [m[idx[2 * i + 1]] for i in range(4)]
    a, b, c, d = _blake_quarter(ops, *cols, mx, my, (16, 12, 8, 7))
    v = [a[0], a[1], a[2], a[3], b[0], b[1], b[2], b[3],
         c[0], c[1], c[2], c[3], d[0], d[1], d[2], d[3]]
    diag = ([v[0], v[1], v[2], v[3]], [v[5], v[6], v[7], v[4]],
            [v[10], v[11], v[8], v[9]], [v[15], v[12], v[13], v[14]])
    mx = [m[idx[8 + 2 * i]] for i in range(4)]
    my = [m[idx[9 + 2 * i]] for i in range(4)]
    a, b, c, d = _blake_quarter(ops, *diag, mx, my, (16, 12, 8, 7))
    return [a[0], a[1], a[2], a[3], b[3], b[0], b[1], b[2],
            c[2], c[3], c[0], c[1], d[1], d[2], d[3], d[0]]


def blake2s(ops, message_bytes, out_len: int = 32):
    """Blake2s-256 over byte values (each a 0..255 word). Unkeyed,
    sequential single-lane — matches barretenberg/acvm Blake2s."""
    h = [ops.const(v) for v in _B2S_IV]
    h[0] = ops.xor_const([h[0]], [0x01010000 ^ out_len])[0]
    nbytes = len(message_bytes)
    blocks = [message_bytes[i:i + 64] for i in range(0, max(nbytes, 1), 64)]
    t = 0
    for bi, block in enumerate(blocks):
        last = bi == len(blocks) - 1
        t += len(block)
        padded = list(block) + [ops.const(0)] * (64 - len(block))
        m = []
        for i in range(16):
            w = padded[4 * i]
            for k in (1, 2, 3):
                w = ops.xor([w], [_shl(ops, padded[4 * i + k], 8 * k)])[0]
            m.append(w)
        v = list(h) + [ops.const(x) for x in _B2S_IV]
        v[12] = ops.xor_const([v[12]], [t & M32])[0]
        v[13] = ops.xor_const([v[13]], [(t >> 32) & M32])[0]
        if last:
            v[14] = ops.xor_const([v[14]], [M32])[0]
        for r in range(10):
            v = _blake2s_round(ops, v, m, _B2S_SIGMA[r])
        h = [ops.xor(ops.xor([h[i]], [v[i]]), [v[i + 8]])[0]
             for i in range(8)]
    # serialize to bytes (little-endian words)
    out = []
    for w in h:
        for k in range(4):
            out.append(_extract_byte(ops, w, k))
    return out[:out_len]


def _shl(ops, x, n):
    if n == 0:
        return x
    # shift-left within 32 bits
    if isinstance(x, int):
        return (x << n) & M32
    v = ops.pr.bshift_l(x, n)
    return ops._w(v)


def _extract_byte(ops, w, k):
    if isinstance(w, int):
        return (w >> (8 * k)) & 0xFF
    from ..mpc.rep3_scalar import BShare

    v = ops.pr.bshift_r(w, 8 * k)
    return BShare(v.a & 0xFF, v.b & 0xFF, 8)


# -- Blake3 -------------------------------------------------------------------

_B3_IV = _B2S_IV
_B3_MSG_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]


def _blake3_compress(ops, cv, block_words, counter, block_len, flags):
    m = list(block_words)
    v = list(cv) + [ops.const(_B3_IV[0]), ops.const(_B3_IV[1]),
                    ops.const(_B3_IV[2]), ops.const(_B3_IV[3]),
                    ops.const(counter & M32), ops.const((counter >> 32) & M32),
                    ops.const(block_len), ops.const(flags)]
    for r in range(7):
        cols = ([v[0], v[1], v[2], v[3]], [v[4], v[5], v[6], v[7]],
                [v[8], v[9], v[10], v[11]], [v[12], v[13], v[14], v[15]])
        mx = [m[2 * i] for i in range(4)]
        my = [m[2 * i + 1] for i in range(4)]
        a, b, c, d = _blake_quarter(ops, *cols, mx, my, (16, 12, 8, 7))
        v = [a[0], a[1], a[2], a[3], b[0], b[1], b[2], b[3],
             c[0], c[1], c[2], c[3], d[0], d[1], d[2], d[3]]
        diag = ([v[0], v[1], v[2], v[3]], [v[5], v[6], v[7], v[4]],
                [v[10], v[11], v[8], v[9]], [v[15], v[12], v[13], v[14]])
        mx = [m[8 + 2 * i] for i in range(4)]
        my = [m[9 + 2 * i] for i in range(4)]
        a, b, c, d = _blake_quarter(ops, *diag, mx, my, (16, 12, 8, 7))
        v = [a[0], a[1], a[2], a[3], b[3], b[0], b[1], b[2],
             c[2], c[3], c[0], c[1], d[1], d[2], d[3], d[0]]
        if r != 6:
            m = [m[i] for i in _B3_MSG_PERM]
    lo = ops.xor(v[:8], v[8:])
    return lo


def blake3(ops, message_bytes, out_len: int = 32):
    """Blake3 hash of < 1024 bytes (single chunk — the Noir blackbox input
    sizes in practice; multi-chunk trees raise)."""
    CHUNK_START, CHUNK_END, ROOT = 1, 2, 8
    if len(message_bytes) > 1024:
        raise NotImplementedError("blake3 multi-chunk input")
    cv = [ops.const(v) for v in _B3_IV]
    blocks = [message_bytes[i:i + 64]
              for i in range(0, max(len(message_bytes), 1), 64)]
    for bi, block in enumerate(blocks):
        padded = list(block) + [ops.const(0)] * (64 - len(block))
        words = []
        for i in range(16):
            w = padded[4 * i]
            for k in (1, 2, 3):
                w = ops.xor([w], [_shl(ops, padded[4 * i + k], 8 * k)])[0]
            words.append(w)
        flags = 0
        if bi == 0:
            flags |= CHUNK_START
        if bi == len(blocks) - 1:
            flags |= CHUNK_END | ROOT
        cv = _blake3_compress(ops, cv, words, 0, len(block), flags)
    out = []
    for w in cv:
        for k in range(4):
            out.append(_extract_byte(ops, w, k))
    return out[:out_len]


# -- AES-128 (CBC, PKCS7) — plain only ---------------------------------------

_AES_SBOX = None


def _gmul(a, b):
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _aes_sbox():
    global _AES_SBOX
    if _AES_SBOX is None:
        inv = [0] * 256
        for x in range(1, 256):
            for y in range(1, 256):
                if _gmul(x, y) == 1:
                    inv[x] = y
                    break
        sbox = []
        for x in range(256):
            q = inv[x]
            s = (q ^ ((q << 1) | (q >> 7)) ^ ((q << 2) | (q >> 6))
                 ^ ((q << 3) | (q >> 5)) ^ ((q << 4) | (q >> 4))) & 0xFF
            sbox.append(s ^ 0x63)
        _AES_SBOX = sbox
    return _AES_SBOX


def _aes_expand_key(key):
    sbox = _aes_sbox()
    rcon = 1
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [sbox[b] for b in t]
            t[0] ^= rcon
            rcon = ((rcon << 1) ^ 0x1B) & 0xFF if rcon & 0x80 else rcon << 1
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [[b for c in range(4) for b in w[4 * r + c]] for r in range(11)]


def _aes_encrypt_block(block, round_keys):
    sbox = _aes_sbox()
    s = [b ^ k for b, k in zip(block, round_keys[0])]

    def sub_shift(s):
        s = [sbox[b] for b in s]
        out = list(s)
        for r in range(1, 4):
            col = [s[r + 4 * c] for c in range(4)]
            col = col[r:] + col[:r]
            for c in range(4):
                out[r + 4 * c] = col[c]
        return out

    def xt(a):
        return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else (a << 1)

    for rnd in range(1, 10):
        s = sub_shift(s)
        mixed = []
        for c in range(4):
            col = s[4 * c:4 * c + 4]
            mixed += [
                xt(col[0]) ^ (xt(col[1]) ^ col[1]) ^ col[2] ^ col[3],
                col[0] ^ xt(col[1]) ^ (xt(col[2]) ^ col[2]) ^ col[3],
                col[0] ^ col[1] ^ xt(col[2]) ^ (xt(col[3]) ^ col[3]),
                (xt(col[0]) ^ col[0]) ^ col[1] ^ col[2] ^ xt(col[3]),
            ]
        s = [b ^ k for b, k in zip(mixed, round_keys[rnd])]
    s = sub_shift(s)
    return [b ^ k for b, k in zip(s, round_keys[10])]


def aes128_encrypt_cbc(message_bytes, iv, key):
    """AES-128-CBC with PKCS7 padding (acvm AES128Encrypt semantics);
    plain ints only."""
    pad = 16 - len(message_bytes) % 16
    data = list(message_bytes) + [pad] * pad
    round_keys = _aes_expand_key(list(key))
    prev = list(iv)
    out = []
    for i in range(0, len(data), 16):
        block = [b ^ p for b, p in zip(data[i:i + 16], prev)]
        enc = _aes_encrypt_block(block, round_keys)
        out += enc
        prev = enc
    return out


# -- shared AES-128 (Rep3): S-box through the oblivious public-table LUT
# gadget; everything else is XOR-domain local (xtime's conditional 0x1B is
# a per-party spread of the high bit, which commutes with XOR-sharing).
# Counterpart of the reference's LUT-based shared AES blackbox
# (co-acvm blackbox_solver + rep3_ring/gadgets/lut_field.rs).

def _bx(a, b):
    from ..mpc.rep3_scalar import BShare

    return BShare(a.a ^ b.a, a.b ^ b.b, 8)


def _bxt(a):
    from ..mpc.rep3_scalar import BShare

    def f(x):
        return ((x << 1) & 0xFF) ^ (0x1B * ((x >> 7) & 1))

    return BShare(f(a.a), f(a.b), 8)


def _sub_shift_shared(ring, fp, s):
    from ..mpc.rep3_ring import read_public_lut_bits_many

    s = read_public_lut_bits_many(ring, fp, _aes_sbox(), s, 8)
    out = list(s)
    for r in range(1, 4):
        col = [s[r + 4 * c] for c in range(4)]
        col = col[r:] + col[:r]
        for c in range(4):
            out[r + 4 * c] = col[c]
    return out


def _aes_expand_key_shared(ring, fp, key):
    from ..mpc.rep3_ring import read_public_lut_bits_many

    rcon = 1
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = read_public_lut_bits_many(ring, fp, _aes_sbox(), t, 8)
            t[0] = fp.bxor_public(t[0], rcon)
            rcon = ((rcon << 1) ^ 0x1B) & 0xFF if rcon & 0x80 else rcon << 1
        w.append([_bx(a, b) for a, b in zip(w[i - 4], t)])
    return [[b for c in range(4) for b in w[4 * r + c]] for r in range(11)]


def _aes_encrypt_block_shared(ring, fp, block, round_keys):
    s = [_bx(b, k) for b, k in zip(block, round_keys[0])]
    for rnd in range(1, 10):
        s = _sub_shift_shared(ring, fp, s)
        mixed = []
        for c in range(4):
            col = s[4 * c:4 * c + 4]
            xts = [_bxt(x) for x in col]
            mixed += [
                _bx(_bx(xts[0], _bx(xts[1], col[1])),
                    _bx(col[2], col[3])),
                _bx(_bx(col[0], xts[1]),
                    _bx(_bx(xts[2], col[2]), col[3])),
                _bx(_bx(col[0], col[1]),
                    _bx(xts[2], _bx(xts[3], col[3]))),
                _bx(_bx(xts[0], col[0]),
                    _bx(col[1], _bx(col[2], xts[3]))),
            ]
        s = [_bx(b, k) for b, k in zip(mixed, round_keys[rnd])]
    s = _sub_shift_shared(ring, fp, s)
    return [_bx(b, k) for b, k in zip(s, round_keys[10])]


def aes128_encrypt_cbc_shared(ring, fp, message, iv, key):
    """AES-128-CBC over 8-bit binary shares (PKCS7, message length
    public). message/iv/key entries are BShares; returns BShares."""
    from ..mpc.rep3_scalar import BShare

    pad = 16 - len(message) % 16
    data = list(message) + [fp.bpromote(pad) for _ in range(pad)]
    data = [BShare(d.a, d.b, 8) for d in data]
    round_keys = _aes_expand_key_shared(ring, fp, list(key))
    prev = list(iv)
    out = []
    for i in range(0, len(data), 16):
        block = [_bx(b, p) for b, p in zip(data[i:i + 16], prev)]
        enc = _aes_encrypt_block_shared(ring, fp, block, round_keys)
        out += enc
        prev = enc
    return out
