"""Radix-2 NTT over prime fields with snarkjs-compatible domains: PyTorch
port of cosnarks_tpu.poly.ntt.

Polynomials are (..., N, nlimbs) Montgomery limb tensors; a transform is a
bit-reverse permutation then log2(N) butterfly stages, each one batched
field mul (K1 on the card) plus an add and a sub. Domains use the snarkjs /
ffjavascript root-of-unity chain, so artifacts stay compatible with snarkjs
zkeys.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff import mont
from ..ff.bigint import ints_to_limbs
from ..ff.spec import Field
from ..utils import timing


def _host_mont_limbs(field: Field, values: list[int]) -> np.ndarray:
    """Host Montgomery limb encoding (int64 numpy)."""
    return ints_to_limbs([field.to_mont_int(v % field.p) for v in values],
                         field.nlimbs).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class Domain:
    """Size-2^k multiplicative subgroup domain with fixed generator. Host
    tables are built once; device copies are cached per device."""

    def __init__(self, field: Field, size: int, group_gen: int):
        if size & (size - 1):
            raise ValueError("domain size must be a power of two")
        self.field = field
        self.size = size
        self.k = size.bit_length() - 1
        self.group_gen = group_gen
        self.group_gen_inv = pow(group_gen, -1, field.p)
        self.size_inv = pow(size, -1, field.p)
        self._host = {}
        self._dev = {}

    def _table(self, key, build, device):
        if key not in self._host:
            self._host[key] = build()
        dkey = (key, device)
        if dkey not in self._dev:
            host = self._host[key]
            if isinstance(host, list):
                self._dev[dkey] = [torch.as_tensor(t, device=device)
                                   for t in host]
            else:
                self._dev[dkey] = torch.as_tensor(host, device=device)
        return self._dev[dkey]

    def _stage_twiddles(self, inverse: bool, device):
        """Per-stage twiddle tables (list of (half, nlimbs) tensors)."""
        def build():
            p = self.field.p
            root = self.group_gen_inv if inverse else self.group_gen
            tables = []
            for s in range(1, self.k + 1):
                m = 1 << s
                half = m >> 1
                w = pow(root, self.size // m, p)
                pw = 1
                powers = []
                for _ in range(half):
                    powers.append(pw)
                    pw = pw * w % p
                tables.append(_host_mont_limbs(self.field, powers))
            return tables

        return self._table(("tw", bool(inverse)), build, device)

    def fft(self, x):
        """Coefficients -> evaluations on the domain (axis -2 of size N)."""
        return _fft(self, x, False)

    def ifft(self, x):
        """Evaluations -> coefficients (includes the 1/N scaling)."""
        return _fft(self, x, True)

    def distribute_powers(self, x, g: int):
        """x_i *= g^i along axis -2 (the odd-domain coset shift)."""
        def build():
            p = self.field.p
            powers = []
            pw = 1
            for _ in range(self.size):
                powers.append(pw)
                pw = pw * g % p
            return _host_mont_limbs(self.field, powers)

        return mont.mul(self.field, x, self._table(("pow", g), build,
                                                   x.device))

    def elements(self):
        """Host list of domain elements [1, g, g^2, ...]."""
        p = self.field.p
        out = [1]
        for _ in range(self.size - 1):
            out.append(out[-1] * self.group_gen % p)
        return out

    def __hash__(self):
        return hash((self.field, self.size, self.group_gen))

    def __eq__(self, o):
        return (isinstance(o, Domain)
                and (o.field, o.size, o.group_gen)
                == (self.field, self.size, self.group_gen))


def _fft(domain: Domain, x, inverse: bool):
    field = domain.field
    n = domain.size
    if x.shape[-2] != n:
        raise ValueError(f"expected axis -2 of size {n}, got {x.shape}")
    with timing.blocking("ntt.bit_reverse"):
        perm = torch.as_tensor(_bit_reverse_perm(domain.k), device=x.device)
    x = x.index_select(-2, perm)
    tables = domain._stage_twiddles(inverse, x.device)
    lead = x.shape[:-2]
    for s in range(1, domain.k + 1):
        m = 1 << s
        half = m >> 1
        w = tables[s - 1]  # (half, nlimbs)
        y = x.reshape(lead + (n // m, m, field.nlimbs))
        even = y[..., :half, :]
        odd = y[..., half:, :]
        t = mont.mul(field, odd, w)
        y = torch.cat([mont.add(field, even, t), mont.sub(field, even, t)],
                      dim=-2)
        x = y.reshape(lead + (n, field.nlimbs))
    if inverse:
        x = mont.mul(field, x, mont.constant(field, domain.size_inv,
                                             device=x.device))
    return x


@functools.lru_cache(maxsize=None)
def groth16_domain(field: Field, size: int) -> Domain:
    """Domain with the snarkjs generator convention: group_gen =
    roots[log2(size)]."""
    k = (size - 1).bit_length() if size > 1 else 0
    n = 1 << k
    roots = field.groth16_roots()
    return Domain(field, n, roots[k])


def groth16_shift_root(field: Field, domain: Domain) -> int:
    """The 2N-th root used for the odd-coset shift: roots[k+1], or qnr^2
    when the domain saturates the 2-adicity."""
    roots = field.groth16_roots()
    if domain.k == field.two_adicity:
        return pow(field.smallest_qnr(), 2, field.p)
    return roots[domain.k + 1]
