"""Field-ops interfaces so curve code is generic over Fq vs Fq2 (PyTorch
port of cosnarks_tpu.ec.ops).

Element layouts:
  Fq : (..., nlimbs)        int64 Montgomery limbs
  Fq2: (..., 2, nlimbs)     c0 + c1*u with u^2 = nonresidue (both curves: -1)

`FqOps` dispatches its products through `mont.mul` (K1 on CUDA tensors);
`PlainFqOps` uses K1's plain version whatever the device, so the plain
versions of the point kernels stay plain torch ops on the card too.
"""

from __future__ import annotations

import torch

from ..ff import mont
from ..ff.spec import Field


class FqOps:
    """Base-field ops: thin veneer over cosnarks_tpu_torch.ff.mont."""

    def __init__(self, field: Field):
        self.field = field
        self.coord_ndim = 1  # trailing dims per element

    def mul(self, a, b):
        return mont.mul(self.field, a, b)

    def mulstack(self, xs, ys):
        # independent products as one batched mul (fewer launches)
        r = self.mul(torch.stack(xs), torch.stack(ys))
        return tuple(r.unbind(0))

    def sqr(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return mont.add(self.field, a, b)

    def sub(self, a, b):
        return mont.sub(self.field, a, b)

    def neg(self, a):
        return mont.neg(self.field, a)

    def double(self, a):
        return mont.add(self.field, a, a)

    def inv(self, a):
        return mont.inv(self.field, a)

    def is_zero(self, a):
        return mont.is_zero(self.field, a)

    def zeros(self, shape=(), device=None):
        return mont.zeros(self.field, shape, device=device)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one(self, shape=(), device=None):
        return mont.broadcast_one(self.field, shape, device=device)

    def one_like(self, a):
        return self.one(a.shape[:-1], device=a.device)

    def constant(self, value, shape=(), device=None):
        return mont.constant(self.field, value, shape, device=device)

    def select(self, mask, a, b):
        return torch.where(mask[..., None], a, b)

    # host <-> device; host representation: python int
    def encode(self, values, device=None):
        return mont.encode(self.field, values, device=device)

    def decode(self, arr, site: str = "mont.decode"):
        return mont.decode(self.field, arr, site=site)

    def __hash__(self):
        return hash((type(self).__name__, self.field))

    def __eq__(self, other):
        return type(other) is type(self) and other.field == self.field


class PlainFqOps(FqOps):
    """FqOps whose products never launch a kernel: the arithmetic of the
    point kernels' plain versions."""

    def mul(self, a, b):
        if a.shape != b.shape:
            a, b = torch.broadcast_tensors(a, b)
        return mont.mul_plain(self.field, a, b)


class Fq2Ops:
    """Quadratic extension Fq[u]/(u^2 - nonresidue); Karatsuba multiply.
    Its three base products run as one stacked K1 call.

    Host representation of an element: (c0, c1) tuple of python ints.
    """

    def __init__(self, field: Field, nonresidue: int = -1):
        if nonresidue != -1:
            raise NotImplementedError("only u^2 = -1 towers so far")
        self.field = field
        self.base = FqOps(field)
        self.coord_ndim = 2

    def mul(self, a, b):
        f = self.field
        if a.shape != b.shape:
            a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        sa, sb = mont.add(f, torch.stack([a0, b0]),
                          torch.stack([a1, b1])).unbind(0)
        t0, t1, t2 = mont.mul(f, torch.stack([a0, a1, sa]),
                              torch.stack([b0, b1, sb])).unbind(0)
        # (a0+a1)(b0+b1) - (t0 + t1) = a0b1 + a1b0 ; u^2 = -1
        t01 = mont.add(f, t0, t1)
        return mont.sub(f, torch.stack([t0, t2], dim=-2),
                        torch.stack([t1, t01], dim=-2))

    def mulstack(self, xs, ys):
        r = self.mul(torch.stack(xs), torch.stack(ys))
        return tuple(r.unbind(0))

    def sqr(self, a):
        f = self.field
        a0, a1 = a[..., 0, :], a[..., 1, :]
        # (a0+a1)(a0-a1) = a0^2 - a1^2 ; c1 = 2 a0 a1
        s = mont.add(f, torch.stack([a0, a0]), torch.stack([a1, a0]))
        return mont.mul(f, s, torch.stack([mont.sub(f, a0, a1), a1])) \
            .movedim(0, -2)

    def add(self, a, b):
        return mont.add(self.field, a, b)

    def sub(self, a, b):
        return mont.sub(self.field, a, b)

    def neg(self, a):
        return mont.neg(self.field, a)

    def double(self, a):
        return self.add(a, a)

    def inv(self, a):
        # (a0 - a1 u) / (a0^2 + a1^2)
        f = self.field
        a0, a1 = a[..., 0, :], a[..., 1, :]
        norm = mont.add(f, mont.sqr(f, a0), mont.sqr(f, a1))
        ninv = mont.inv(f, norm)
        return torch.stack(
            [mont.mul(f, a0, ninv), mont.neg(f, mont.mul(f, a1, ninv))],
            dim=-2)

    def is_zero(self, a):
        return (a == 0).all(-1).all(-1)

    def zeros(self, shape=(), device=None):
        return mont.zeros(self.field, tuple(shape) + (2,), device=device)

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def one(self, shape=(), device=None):
        return torch.stack(
            [mont.broadcast_one(self.field, shape, device=device),
             mont.zeros(self.field, shape, device=device)], dim=-2)

    def one_like(self, a):
        return self.one(a.shape[:-2], device=a.device)

    def constant(self, value, shape=(), device=None):
        c0, c1 = value  # tuple of ints
        return torch.stack(
            [mont.constant(self.field, c0, shape, device=device),
             mont.constant(self.field, c1, shape, device=device)], dim=-2)

    def select(self, mask, a, b):
        return torch.where(mask[..., None, None], a, b)

    def encode(self, values, device=None):
        flat = []
        for c0, c1 in values:
            flat.extend([c0, c1])
        arr = mont.encode(self.field, flat, device=device)
        return arr.reshape(len(values), 2, self.field.nlimbs)

    def decode(self, arr, site: str = "mont.decode"):
        ints = mont.decode(self.field, arr.reshape(-1, self.field.nlimbs),
                           site=site)
        return [(ints[i], ints[i + 1]) for i in range(0, len(ints), 2)]

    def __hash__(self):
        return hash(("fq2", self.field))

    def __eq__(self, other):
        return type(other) is Fq2Ops and other.field == self.field
