"""ChaCha20 counter-mode PRF in int64 torch ops: port of
cosnarks_tpu.mpc.chacha.

uint32 words live in int64 tensors (torch has no uint32 add, shift or
compare); every add and rotate is masked with 0xFFFFFFFF, so the keystream
is bit-exact with the JAX package's.

Stream addressing: (key, label, draw_counter) picks an independent stream;
block indices within one draw run 0..n_blocks-1 in the ChaCha counter words.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils import timing

_CONST = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
M32 = 0xFFFFFFFF


def key_to_words(key: bytes) -> np.ndarray:
    """32-byte key -> 8 little-endian words (int64)."""
    if len(key) != 32:
        raise ValueError("ChaCha key must be 32 bytes")
    return np.frombuffer(key, dtype="<u4").astype(np.int64)


def derive_key(key: bytes, label: bytes) -> bytes:
    """Domain-separated 256-bit subkey (host side, for fork())."""
    return hashlib.blake2b(label, key=key, digest_size=32).digest()


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _quarter(a, b, c, d):
    a = (a + b) & M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & M32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def blocks(key_words, nonce, n_blocks: int):
    """ChaCha20 keystream: (n_blocks, 16) words.

    key_words: (8,) int64 tensor; nonce: (label, draw counter) ints; the
    64-bit ChaCha block counter enumerates the batch."""
    dev = key_words.device
    idx = torch.arange(n_blocks, dtype=torch.int64, device=dev)
    with timing.blocking("chacha.blocks"):
        a0 = torch.tensor(_CONST, dtype=torch.int64, device=dev).expand(
            n_blocks, 4)
    b0 = key_words[:4].expand(n_blocks, 4)
    c0 = key_words[4:].expand(n_blocks, 4)
    d0 = torch.stack([idx, torch.zeros_like(idx),
                      torch.full_like(idx, int(nonce[0]) & M32),
                      torch.full_like(idx, int(nonce[1]) & M32)], dim=-1)
    a, b, c, d = a0, b0, c0, d0
    for _ in range(10):  # 10 double rounds = ChaCha20
        a, b, c, d = _quarter(a, b, c, d)  # column round
        b = torch.roll(b, -1, dims=-1)  # diagonalize
        c = torch.roll(c, -2, dims=-1)
        d = torch.roll(d, -3, dims=-1)
        a, b, c, d = _quarter(a, b, c, d)
        b = torch.roll(b, 1, dims=-1)
        c = torch.roll(c, 2, dims=-1)
        d = torch.roll(d, 3, dims=-1)
    return torch.cat([(a + a0) & M32, (b + b0) & M32, (c + c0) & M32,
                      (d + d0) & M32], dim=-1)


def limbs16(key_words, nonce, n_limbs: int):
    """Keystream as (n_limbs,) 16-bit limbs (LE word order)."""
    n_blocks = -(-n_limbs // 32)
    w = blocks(key_words, nonce, n_blocks)  # (B, 16)
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(n_blocks * 32)
    return limbs[:n_limbs]
