"""Rep3 shared-vector driver for the collaborative UltraHonk prover:
PyTorch port of cosnarks_tpu.honk.co_driver.

The MPC counterpart of relations.FV: an `SVec` holds a party's share of
a vector in its driver's form, here the port's `mpc.rep3.Share` of two
(k, 16) Montgomery limb tensors on the device (honk/shamir_honk.py's
driver keeps one tensor). Every operation goes through the driver, so a
public constant lands where the protocol needs it. Linear algebra
(add/sub/neg, public scaling) is local; `*` between two SVecs is ONE
batched Rep3 multiplication round
(`rep3.local_mul` + `reshare`, mpc-core rep3/arithmetic.rs:104-177)
through the driver bound to the operands, so the plain relation formulas
in relations.py run unchanged over shares, each operator call a
whole-vector round (cf. T::mul_many in co-ultrahonk/src/co_decider/
relations/*.rs).

Openings go through `rep3.open`. The masked zero-leaking batch inversion
(CoUtils::batch_invert_leaking_zeros) and the constant-round prefix
product (array_prod_mul, co-plonk/src/mpc/rep3.rs:182-218) keep the JAX
package's rounds; the prefix product of the opened values is the doubling
scan. Commitments open as the JAX package opens them: each party runs
`msm()` over its `a` component (uniform shares, so the partial MSMs reveal
nothing beyond the opened commitment), broadcasts the affine point and
the points are added on the host.
"""

from __future__ import annotations

import torch

from ..ec import curves
from ..ec.host import host_curve
from ..mpc import rep3
from ..mpc.rep3 import Share
from ..plonk.prove import scan
from . import polyops
from .polyops import FR


class SVec:
    """A party's share of a vector, `s`, in its driver's form: a Rep3
    `Share` of two (k, 16) Montgomery limb tensors here, one (k, 16)
    tensor for a Shamir driver (honk/shamir_honk.py). Every operation goes
    through the driver bound to it, so the relation formulas run unchanged
    over either protocol."""

    __slots__ = ("s", "drv")
    _is_shared = True

    def __init__(self, s, drv):
        self.s = s
        self.drv = drv

    def __len__(self):
        return self.drv.comps(self.s)[0].shape[0]

    # -- linear -------------------------------------------------------------
    def _pub(self, o):
        """Public operand -> limb tensor (FV or python int)."""
        if hasattr(o, "t"):
            return o.t  # relations.FV
        return polyops.const(o, self.device)

    def __add__(self, o):
        if isinstance(o, SVec):
            return SVec(self.drv.add(self.s, o.s), self.drv)
        return SVec(self.drv.add_public(self.s, self._pub(o)), self.drv)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, SVec):
            return SVec(self.drv.sub(self.s, o.s), self.drv)
        neg = polyops.sub(torch.zeros_like(self._pub(o)), self._pub(o))
        return SVec(self.drv.add_public(self.s, neg), self.drv)

    def __rsub__(self, o):
        return self.__neg__().__add__(o)

    def __neg__(self):
        return SVec(self.drv.neg(self.s), self.drv)

    def __mul__(self, o):
        if isinstance(o, SVec):
            return self.drv.mul_vec(self, o)
        return SVec(self.drv.mul_public(self.s, self._pub(o)), self.drv)

    __rmul__ = __mul__

    # -- sumcheck plumbing (mirrors relations.FV) ---------------------------
    def block_sums(self, nblocks: int) -> "SVec":
        def per(t):
            t = t.reshape(nblocks, -1, t.shape[-1])
            return polyops.sum_rows(t.transpose(0, 1))

        return SVec(self.drv.lin(per, self.s), self.drv)

    @property
    def device(self):
        return self.drv.comps(self.s)[0].device


class ZeroPool:
    """Additive zero shares (r_i - r_(i+1), summing to zero over the three
    parties) drawn in batches from the party's correlated randomness and
    handed out in order, each element once. Every draw costs the same
    ~1500 torch ops whatever its size, and a proof takes about a thousand
    multiplications, so one draw per multiplication would cost more
    launches than the proof itself. All parties run the same sequence of
    multiplications, so they take the same elements. A batch is 2^20
    elements on the card (a 2^16-row proof uses about 2^25) and 2^14 on
    the CPU, where a draw's torch ops are slow and proofs small."""

    def __init__(self, state: rep3.Rep3State):
        self.state = state
        self.batch = 1 << (20 if state.device.type == "cuda" else 14)
        self.buf = None
        self.pos = 0

    def take(self, k: int) -> torch.Tensor:
        if self.buf is None or self.pos + k > self.buf.shape[0]:
            self.buf = self.state.rng.zero_additive(
                FR, (max(k, self.batch),))
            self.pos = 0
        out = self.buf[self.pos:self.pos + k]
        self.pos += k
        return out


class Rep3HonkDriver:
    """Whole-vector Rep3 protocol over device shares, bound to a party
    network and its correlated randomness (`rep3.Rep3State`). Also the
    `ops` object of the prover's generic sumcheck and opening phases."""

    def __init__(self, net, state: rep3.Rep3State):
        self.net = net
        self.state = state
        self.id = net.id
        self.device = state.device
        self.rounds = 0
        self.zeros_pool = ZeroPool(state.fork())

    # -- construction -------------------------------------------------------
    def wrap(self, a, b) -> SVec:
        """SVec from the share's component tensors (`comps`' inverse)."""
        return SVec(Share(a, b), self)

    def vec(self, x: Share) -> SVec:
        return SVec(x, self)

    @staticmethod
    def comps(x: Share) -> tuple:
        """The share's component tensors: (a, b)."""
        return (x.a, x.b)

    @staticmethod
    def to_share(col, device) -> Share:
        """A column of host AShares, or a Share, as a Share on `device`."""
        if isinstance(col, Share):
            return Share(col.a.to(device), col.b.to(device))
        return Share(polyops.encode([s.a for s in col], device),
                     polyops.encode([s.b for s in col], device))

    def promote(self, t) -> Share:
        """Public tensor -> trivial share."""
        return rep3.promote_public(FR, t, self.id)

    def rand(self, k: int) -> Share:
        return rep3.rand(FR, self.state, (k,))

    # -- the prover's ops interface ------------------------------------------
    def lin(self, fn, *xs):
        """A linear tensor function applied to each share component."""
        return Share(fn(*[x.a for x in xs]), fn(*[x.b for x in xs]))

    @staticmethod
    def add(x: Share, y: Share) -> Share:
        return rep3.add(FR, x, y)

    @staticmethod
    def sub(x: Share, y: Share) -> Share:
        return rep3.sub(FR, x, y)

    @staticmethod
    def neg(x: Share) -> Share:
        return rep3.neg(FR, x)

    def add_public(self, x: Share, v) -> Share:
        """x + v for a public tensor v: one component on parties 0 and 2."""
        return rep3.add_public(FR, x, v, self.id)

    @staticmethod
    def mul_public(x: Share, v) -> Share:
        return rep3.mul_public(FR, x, v)

    def zeros(self, k: int) -> Share:
        z = polyops.zeros(k, self.device)
        return Share(z, z)

    def open(self, x: Share) -> list[int]:
        return polyops.decode(self.open_t(x))

    def commit(self, poly: Share, crs):
        return self.commit_open(poly, crs)

    # -- protocol -----------------------------------------------------------
    def local_mul(self, x: Share, y: Share) -> torch.Tensor:
        """Additive share of x*y: x_a y_a + x_a y_b + x_b y_a + a zero
        share from the pool (rep3.local_mul's products, batched masks)."""
        prods = polyops.mul(torch.stack([x.a, x.a, x.b]),
                            torch.stack([y.a, y.b, y.a]))
        acc = polyops.add(polyops.add(prods[0], prods[1]), prods[2])
        return polyops.add(acc, self.zeros_pool.take(x.a.shape[0]))

    def mul(self, x: Share, y: Share) -> Share:
        self.rounds += 1
        return rep3.reshare(FR, self.local_mul(x, y), self.net)

    def mul_vec(self, x: SVec, y: SVec) -> SVec:
        return SVec(self.mul(x.s, y.s), self)

    def open_t(self, x: Share) -> torch.Tensor:
        self.rounds += 1
        return rep3.open(FR, x, self.net)

    def mul_open(self, x: Share, y: Share) -> torch.Tensor:
        """Open x * y: every party broadcasts its re-randomised additive
        share of the product (one round)."""
        self.rounds += 1
        return rep3.open_additive(FR, self.local_mul(x, y), self.net)

    def inv_vec_leaking_zeros(self, x: Share) -> Share:
        """Masked batch inversion; zero entries open as zero and stay zero
        (CoUtils::batch_invert_leaking_zeros)."""
        r = self.rand(x.a.shape[0])
        inv = polyops.batch_invert(self.mul_open(x, r))
        return rep3.mul_public(FR, r, inv)

    def inv_vec(self, x: Share) -> Share:
        r = self.rand(x.a.shape[0])
        opened = self.mul_open(x, r)
        if bool((opened == 0).all(-1).any()):
            raise ZeroDivisionError("cannot invert zero share")
        return rep3.mul_public(FR, r, polyops.batch_invert(opened))

    def array_prod_mul(self, arr: Share) -> Share:
        """Constant-round prefix products out[i] = prod_{j<=i} arr[j]
        (co-plonk/src/mpc/rep3.rs:182-218)."""
        n = arr.a.shape[0]
        r = self.rand(n + 1)
        r_inv = self.inv_vec(r)
        r_head = Share(r_inv.a[:1].expand(n, -1), r_inv.b[:1].expand(n, -1))
        unblind = self.mul(r_head, Share(r.a[1:], r.b[1:]))
        masked = self.mul(Share(r.a[:n], r.b[:n]), arr)
        opened = self.mul_open(masked, Share(r_inv.a[1:], r_inv.b[1:]))
        prefix = scan(polyops.mul, opened)
        return rep3.mul_public(FR, unblind, prefix)

    # -- EC commitments -----------------------------------------------------
    def commit_open(self, coeffs: Share, crs):
        """Commit to a shared polynomial and open the commitment: each
        party commits to its additive component ('a') (`polyops.commit`:
        `msm()` on a device CRS), then the three affine points are
        exchanged and summed on the host (rep3 pointshare
        open_half_point)."""
        mine = polyops.commit(coeffs.a, crs)
        others = self.net.broadcast(_encode_pt(mine))
        self.rounds += 1
        g1 = host_curve(curves.BN254_G1)
        acc = g1.lift_affine(mine)
        for enc in others.values():
            acc = g1.add(acc, g1.lift_affine(_decode_pt(enc)))
        return g1.affine_ints(acc) if acc is not None else None


def _encode_pt(pt):
    return ("inf",) if pt is None else (int(pt[0]), int(pt[1]))


def _decode_pt(enc):
    if enc is None or (isinstance(enc, (tuple, list)) and enc
                       and enc[0] == "inf"):
        return None
    return (int(enc[0]), int(enc[1]))
