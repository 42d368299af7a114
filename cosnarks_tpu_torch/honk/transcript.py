"""Port of `cosnarks_tpu.honk.transcript`: host Python, copied unchanged.

Fiat-Shamir transcript for UltraHonk, Barretenberg-compatible.

Mirrors the reference Transcript (co-noir-common/src/transcript.rs:117-458)
with its two hasher flavors:

- Poseidon2Sponge (transcript.rs:13, sponge_hasher.rs): data type is a
  BN254-Fr element; hashing is the t=4/rate-3 Poseidon2 field sponge with
  iv = (input_len << 64) + out_len - 1; points serialize as 2 Fr per Fq
  coordinate (136-bit low / 118-bit high split, honk_curve.rs:241-258).
- Keccak256 (keccak_hash.rs): data type is a 256-bit integer (U256);
  hashing is keccak256 over 32-byte big-endian words; points serialize as
  1 U256 per coordinate.

Challenge generation (transcript.rs:354-428): hash previous challenge ++
round data, reduce into Fr, split into two 127-bit halves; a list of k
challenges consumes ceil(k/2) duplex calls.

All field elements are canonical python ints; proof buffers are sequences
of 32-byte big-endian words (noir-types/src/lib.rs SerializeF / U256).
"""

from __future__ import annotations

from ..ff.spec import BN254_FQ, BN254_FR
from ..gadgets.poseidon2 import Poseidon2
from ..utils.keccak import keccak256

R = BN254_FR.p
Q = BN254_FQ.p

_LOW136 = (1 << 136) - 1
_LOW127 = (1 << 127) - 1


class _PlainFr:
    """Minimal driver for the Poseidon2 permutation over public ints."""

    def __init__(self, p):
        self.p = p

    def add(self, a, b):
        return (a + b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def mul_many(self, xs, ys):
        return [(x * y) % self.p for x, y in zip(xs, ys)]


_POS_DRIVER = _PlainFr(R)
_POS = Poseidon2(4, R)


def poseidon2_hash(inputs: list[int], out_len: int = 1) -> list[int]:
    """FieldSponge::hash_fixed_length (sponge_hasher.rs:121-148):
    t=4, rate=3 duplex sponge over BN254 Fr."""
    rate = 3
    iv = ((len(inputs) << 64) + out_len - 1) % R
    state = [0, 0, 0, iv]
    cache: list[int] = []
    # absorb
    for x in inputs:
        if len(cache) == rate:
            for i in range(rate):
                state[i] = (state[i] + cache[i]) % R
            state = _POS.permutation(_POS_DRIVER, state)
            cache = []
        cache.append(x % R)
    # final duplex + squeeze
    out = []
    for i in range(rate):
        state[i] = (state[i] + (cache[i] if i < len(cache) else 0)) % R
    state = _POS.permutation(_POS_DRIVER, state)
    squeezed = list(state[:rate])
    while len(out) < out_len:
        if not squeezed:
            state = _POS.permutation(_POS_DRIVER, state)
            squeezed = list(state[:rate])
        out.append(squeezed.pop(0))
    return out


def fq_to_two_fr(x: int) -> tuple[int, int]:
    """Split an Fq coordinate into (low 136 bits, high 118 bits) as two Fr
    elements (honk_curve.rs bn254_fq_to_fr)."""
    return x & _LOW136, x >> 136


def two_fr_to_fq(lo: int, hi: int) -> int:
    if lo >= 1 << 136 or hi >= 1 << 118:
        raise ValueError("invalid two-limb Fq encoding")
    return (lo + (hi << 136)) % Q


class Poseidon2Hasher:
    """DataType = Fr canonical int."""

    name = "poseidon2"
    USE_PADDING = True
    NUM_BASEFIELD_ELEMENTS = 2

    @staticmethod
    def hash(buffer: list[int]) -> int:
        return poseidon2_hash(buffer, 1)[0]

    @staticmethod
    def fr_into(v: int) -> list[int]:
        return [v % R]

    @staticmethod
    def fr_back(elems: list[int]) -> int:
        return elems[0] % R

    @staticmethod
    def point_into(pt) -> list[int]:
        if pt is None:  # infinity -> (0, 0) (transcript.rs:58-63)
            return [0, 0, 0, 0]
        x, y = pt
        xl, xh = fq_to_two_fr(x)
        yl, yh = fq_to_two_fr(y)
        return [xl, xh, yl, yh]

    @staticmethod
    def point_back(elems: list[int]):
        x = two_fr_to_fq(elems[0], elems[1])
        y = two_fr_to_fq(elems[2], elems[3])
        if x == 0 and y == 0:
            return None
        return (x, y)

    @staticmethod
    def u64_into(v: int) -> int:
        return v % R

    @staticmethod
    def to_field(v: int) -> int:
        """convert_destinationfield_to_scalarfield"""
        return v % R

    @staticmethod
    def field_to_data(v: int) -> int:
        return v % R

    @staticmethod
    def split_challenge(v: int) -> tuple[int, int]:
        return v & _LOW127, (v >> 127) & _LOW127

    @staticmethod
    def to_buffer(elems: list[int]) -> bytes:
        return b"".join(int(e % R).to_bytes(32, "big") for e in elems)

    @staticmethod
    def from_buffer(buf: bytes) -> list[int]:
        if len(buf) % 32:
            raise ValueError("proof buffer length not a multiple of 32")
        return [int.from_bytes(buf[i:i + 32], "big") % R
                for i in range(0, len(buf), 32)]


class KeccakHasher:
    """DataType = U256 int (may exceed r; reduced when used as Fr)."""

    name = "keccak"
    USE_PADDING = False
    NUM_BASEFIELD_ELEMENTS = 1

    @staticmethod
    def hash(buffer: list[int]) -> int:
        data = b"".join(int(e).to_bytes(32, "big") for e in buffer)
        return int.from_bytes(keccak256(data), "big")

    @staticmethod
    def fr_into(v: int) -> list[int]:
        return [v % R]

    @staticmethod
    def fr_back(elems: list[int]) -> int:
        return elems[0] % R

    @staticmethod
    def point_into(pt) -> list[int]:
        if pt is None:
            return [0, 0]
        return [pt[0] % Q, pt[1] % Q]

    @staticmethod
    def point_back(elems: list[int]):
        x, y = elems[0] % Q, elems[1] % Q
        if x == 0 and y == 0:
            return None
        return (x, y)

    @staticmethod
    def u64_into(v: int) -> int:
        return int(v)

    @staticmethod
    def to_field(v: int) -> int:
        return v % R

    @staticmethod
    def field_to_data(v: int) -> int:
        return v % R

    @staticmethod
    def split_challenge(v: int) -> tuple[int, int]:
        return v & _LOW127, (v >> 127) & _LOW127

    @staticmethod
    def to_buffer(elems: list[int]) -> bytes:
        return b"".join(int(e).to_bytes(32, "big") for e in elems)

    @staticmethod
    def from_buffer(buf: bytes) -> list[int]:
        if len(buf) % 32:
            raise ValueError("proof buffer length not a multiple of 32")
        return [int.from_bytes(buf[i:i + 32], "big")
                for i in range(0, len(buf), 32)]


HASHERS = {"poseidon2": Poseidon2Hasher, "keccak": KeccakHasher}


def validate_g1(pt, label: str = "point"):
    """Reject off-curve proof/vk points (invalid-curve attack surface).

    The reference constructs ark G1Affine values, which assert on-curve +
    subgroup membership on deserialization; BN254 G1 is prime-order, so the
    curve equation y^2 = x^3 + 3 over Fq suffices. Infinity (None) passes.
    """
    if pt is None:
        return None
    x, y = pt[0] % Q, pt[1] % Q
    if (y * y - (x * x * x + 3)) % Q:
        raise ValueError(f"proof point {label!r} is not on BN254 G1")
    return (x, y)


class Transcript:
    """Prover/verifier transcript (transcript.rs:117-458)."""

    def __init__(self, hasher, proof: list[int] | None = None):
        self.h = hasher
        self.proof_data: list[int] = list(proof) if proof is not None else []
        self.num_read = 0
        self.is_first_challenge = True
        self.round_data: list[int] = []
        self.independent_buffer: list[int] = []
        self.previous_challenge = 0

    # -- prover side --------------------------------------------------------
    def _absorb(self, elems: list[int]):
        self.round_data.extend(elems)

    def _send(self, elems: list[int]):
        self.proof_data.extend(elems)
        self._absorb(elems)

    def send_fr(self, label: str, v: int):
        self._send(self.h.fr_into(v))

    def send_frs(self, label: str, vs):
        for v in vs:
            self.send_fr(label, v)

    def send_point(self, label: str, pt):
        self._send(self.h.point_into(pt))

    def send_u64(self, label: str, v: int):
        self._send([self.h.u64_into(v)])

    def add_fr_to_hash_buffer(self, label: str, v: int):
        self._absorb(self.h.fr_into(v))

    def add_u64_to_independent_hash_buffer(self, label: str, v: int):
        self.independent_buffer.append(self.h.u64_into(v))

    def add_point_to_independent_hash_buffer(self, label: str, pt):
        self.independent_buffer.extend(self.h.point_into(pt))

    def hash_independent_buffer(self) -> int:
        res = self.h.hash(self.independent_buffer)
        self.independent_buffer = []
        return self.h.to_field(res)

    # -- verifier side ------------------------------------------------------
    def _receive(self, n: int) -> list[int]:
        if self.num_read + n > len(self.proof_data):
            raise ValueError("proof too small")
        elems = self.proof_data[self.num_read:self.num_read + n]
        self.num_read += n
        self._absorb(elems)
        return elems

    def receive_fr(self, label: str) -> int:
        return self.h.fr_back(self._receive(1))

    def receive_frs(self, label: str, n: int) -> list[int]:
        return [self.receive_fr(label) for _ in range(n)]

    def receive_point(self, label: str):
        pt = self.h.point_back(self._receive(2 * self.h.NUM_BASEFIELD_ELEMENTS))
        return validate_g1(pt, label)

    # -- challenges ---------------------------------------------------------
    def _next_duplex(self) -> tuple[int, int]:
        if self.is_first_challenge:
            assert self.round_data, "no prover data before first challenge"
            buf = list(self.round_data)
            self.is_first_challenge = False
        else:
            buf = [self.previous_challenge] + self.round_data
        self.round_data = []
        new = self.h.hash(buf)
        as_field = self.h.to_field(new)
        new = self.h.field_to_data(as_field)
        self.previous_challenge = new
        return self.h.split_challenge(new)

    def get_challenge(self, label: str) -> int:
        return self.h.to_field(self._next_duplex()[0])

    def get_challenges(self, labels: list[str]) -> list[int]:
        n = len(labels)
        out = []
        for _ in range(n // 2):
            lo, hi = self._next_duplex()
            out.append(self.h.to_field(lo))
            out.append(self.h.to_field(hi))
        if n & 1:
            out.append(self.h.to_field(self._next_duplex()[0]))
        return out

    def get_powers_of_challenge(self, label: str, n: int) -> list[int]:
        c = self.get_challenge(label)
        pows = []
        if n > 0:
            pows.append(c)
            for _ in range(1, n):
                pows.append(pows[-1] * pows[-1] % R)
        return pows

    def get_proof(self) -> list[int]:
        return list(self.proof_data)
