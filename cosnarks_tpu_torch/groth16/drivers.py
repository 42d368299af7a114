"""Groth16 MPC drivers: the per-protocol ops the prover is generic over
(port of cosnarks_tpu.groth16.drivers: plain, Rep3 and Shamir). "Half
shares" are additive (Rep3) or degree-2t (Shamir) shares — after the witness
map everything runs on plain per-party tensors + group sums, so the heavy
kernels (MSM, NTT, scalar-mul) are identical across drivers.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..ec import curve as ec
from ..ec import msm as msm_mod
from ..ff import mont
from ..mpc import chacha, rep3, shamir
from ..mpc.rng import LABEL_FIELD, draw_field
from . import witness_map as wm


class PlainDriver:
    """Single-party driver (the plain oracle)."""

    id = 0

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self._key = torch.as_tensor(
            chacha.key_to_words(seed.to_bytes(32, "little")),
            device=self.device)
        self._ctr = 0

    # share plumbing
    def full_witness(self, field, public_ints, private):
        pub = mont.encode(field, public_ints, device=self.device)
        return torch.cat([pub, private], dim=0)

    def matvec(self, field, rows, cols, vals, w, out):
        return wm.sparse_matvec(field, rows, cols, vals, w, out)

    def map_share(self, fn, x):
        return fn(x)

    def local_mul_vec(self, field, a, b):
        return mont.mul(field, a, b)

    def rand(self, field):
        self._ctr += 1
        return draw_field(self._key, LABEL_FIELD, self._ctr, field, ())

    def local_mul_scalar(self, field, r, s):
        return mont.mul(field, r, s)

    def to_half(self, x):
        return x

    def rand_to_half(self, r):
        return r

    # points
    def open_half_point(self, spec, pt):
        return pt

    def scalar_mul_half_point(self, spec, pt_half, r):
        """[r] * additive-shared point, r a `rand` share."""
        return ec.scalar_mul(spec, pt_half,
                             mont.from_mont(spec.scalar_field, r))

    def add_public_point(self, spec, pt, public_pt):
        """Add a public point (only party 0 contributes to additive sums)."""
        return ec.add(spec, pt, public_pt)


class Rep3Driver:
    """3-party replicated driver."""

    def __init__(self, net, state: rep3.Rep3State):
        self.net = net
        self.state = state
        self.id = net.id
        self.device = state.device

    def full_witness(self, field, public_ints, private: rep3.Share):
        pub = mont.encode(field, public_ints, device=self.device)
        pub_share = rep3.promote_public(field, pub, self.id)
        return rep3.Share(torch.cat([pub_share.a, private.a], dim=0),
                          torch.cat([pub_share.b, private.b], dim=0))

    def matvec(self, field, rows, cols, vals, w: rep3.Share, out):
        return rep3.Share(
            wm.sparse_matvec(field, rows, cols, vals, w.a, out),
            wm.sparse_matvec(field, rows, cols, vals, w.b, out))

    def map_share(self, fn, x: rep3.Share):
        res = fn(torch.stack([x.a, x.b]))
        return rep3.Share(res[0], res[1])

    def local_mul_vec(self, field, a: rep3.Share, b: rep3.Share):
        return rep3.local_mul(field, a, b, self.state)

    def rand(self, field):
        return rep3.rand(field, self.state)

    def local_mul_scalar(self, field, r: rep3.Share, s: rep3.Share):
        return rep3.local_mul(field, r, s, self.state)

    def to_half(self, x: rep3.Share):
        return x.a

    def rand_to_half(self, r: rep3.Share):
        return r.a

    def open_half_point(self, spec, pt):
        return rep3.point_open_additive(spec, pt, self.net, self.state)

    def scalar_mul_half_point(self, spec, pt_half, r: rep3.Share):
        repl = rep3.point_reshare(spec, pt_half, self.net, self.state)
        return rep3.point_scalar_mul_local(spec, repl, r, self.state)

    def add_public_point(self, spec, pt, public_pt):
        if self.id == 0:
            return ec.add(spec, pt, public_pt)
        return pt


class ShamirDriver(PlainDriver):
    """n-party Shamir driver. Shares are single tensors that each party
    computes on as the plain driver does on its values: public values are
    constant-polynomial shares, a product of degree-t shares is a valid
    degree-2t "half share", and adding a public point shifts every share.
    `rand`, the half-point opens (interpolation of 2t+1 contributions in the
    exponent) and [r]*B (after a king point degree reduction) use the
    network."""

    def __init__(self, net, state: shamir.ShamirState):
        self.net = net
        self.state = state
        self.id = net.id
        self.device = state.device

    def rand(self, field):
        return shamir.rand(field, self.state, net=self.net)

    def open_half_point(self, spec, pt):
        return shamir.open_point(spec, pt, self.net, self.state,
                                 degree=2 * self.state.t)

    def scalar_mul_half_point(self, spec, pt_half, r):
        reduced = shamir.degree_reduce_point(spec, pt_half, self.net,
                                             self.state)
        return ec.scalar_mul(spec, reduced,
                             mont.from_mont(spec.scalar_field, r))


def msm_half(spec, points, scalars_mont):
    """MSM of public points with additive-share scalars: each party runs a
    full plain MSM over its own summands."""
    if points[0].shape[0] == 0:
        return ec.point_inf(spec, device=points[0].device)
    std = mont.from_mont(spec.scalar_field, scalars_mont)
    return msm_mod.msm(spec, points, std)


def scalar_mul_public_point(spec, public_pt, scalar_half_mont):
    """[half-share scalar] * public point."""
    return ec.scalar_mul(
        spec, public_pt, mont.from_mont(spec.scalar_field, scalar_half_mont))
