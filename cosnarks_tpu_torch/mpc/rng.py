"""Correlated randomness for Rep3 — ChaCha20 counter-PRF streams (port of
cosnarks_tpu.mpc.rng).

Party i holds 256-bit keys (k_i, k_{i+1}); any value derived from k_j is
computable by both parties that know k_j, so replicated random shares and
zero shares need no communication. Draws are counter-addressed ChaCha20
blocks generated in bulk on the keys' device.

fork() derives fresh 256-bit child keys via keyed BLAKE2b.
"""

from __future__ import annotations

import os

import torch

from .. import resolve_device
from ..ff import mont
from ..ff.spec import Field
from ..utils import timing
from . import chacha

# stream labels (nonce word 0); one label per draw "kind"
LABEL_FIELD = 0


def draw_field(key_words, label: int, counter: int, field: Field, shape):
    """Uniform field element(s) in the Montgomery domain: draw 2n 16-bit
    limbs and reduce mod p with `mont.reduce_columns` — including its
    dropped carry for inputs >= p*R, exactly as the JAX package draws."""
    n = field.nlimbs
    count = 1
    for s in shape:
        count *= s
    total = count * 2 * n if shape else 2 * n
    limbs = chacha.limbs16(key_words, (label, counter), total)
    cols = limbs.reshape(tuple(shape) + (2 * n,))
    return mont.reduce_columns(field, cols)


class PartyRng:
    """One party's correlated PRF state: my key stream + next party's.

    `key_bytes_mine` is shared with the previous party (they hold it as
    their key_next), `key_bytes_next` with the next party."""

    def __init__(self, key_mine: bytes, key_next: bytes, counter: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.key_bytes_mine = key_mine
        self.key_bytes_next = key_next
        with timing.blocking("rng.keys", syncs=2):
            self.key_mine = torch.as_tensor(chacha.key_to_words(key_mine),
                                            device=self.device)
            self.key_next = torch.as_tensor(chacha.key_to_words(key_next),
                                            device=self.device)
        self._counter = counter

    @classmethod
    def setup(cls, net, seed: bytes | None = None, device=None):
        """One round: generate my 256-bit key, send to prev party, recv next
        party's (so party i ends with (k_i, k_{i+1}))."""
        if seed is None:
            seed = os.urandom(32)
        if len(seed) != 32:
            seed = hashlib_expand(seed)
        key_next = bytes(net.reshare_backward(seed))
        return cls(seed, key_next, device=device)

    def _next_counter(self) -> int:
        c = self._counter
        self._counter += 1
        return c

    def rand_share(self, field: Field, shape=()):
        """Replicated share (r_i, r_{i+1}) of an unknown uniform value."""
        c = self._next_counter()
        return (draw_field(self.key_mine, LABEL_FIELD, c, field, shape),
                draw_field(self.key_next, LABEL_FIELD, c, field, shape))

    def zero_additive(self, field: Field, shape=()):
        """Additive share of zero: r_i - r_{i+1} (sums to 0 over parties)."""
        a, b = self.rand_share(field, shape)
        return mont.sub(field, a, b)

    def fork(self, idx: int = 0) -> "PartyRng":
        """Independent substream via key derivation (same on all parties)."""
        label = b"fork" + int(idx).to_bytes(8, "little")
        return PartyRng(chacha.derive_key(self.key_bytes_mine, label),
                        chacha.derive_key(self.key_bytes_next, label),
                        device=self.device)


def hashlib_expand(seed: bytes) -> bytes:
    """Stretch a short seed to 32 bytes (testing convenience only)."""
    return chacha.derive_key(seed.ljust(32, b"\0")[:32], b"seed-expand")
