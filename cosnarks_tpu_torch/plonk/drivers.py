"""PLONK MPC drivers: the whole-vector protocol ops the 5-round prover is
generic over (port of cosnarks_tpu.plonk.drivers; the reference's
`CircomPlonkProver` trait, co-plonk/src/mpc.rs:16-164, with plain / Rep3 /
Shamir implementations, co-plonk/src/mpc/{plain,rep3,shamir}.rs).

Share vectors are Montgomery limb tensors on the driver's device: plain and
Shamir = (k, nlimbs), Rep3 = Share(a, b) pairs. Every op is whole-vector
(one network round per `mul` / `open` call whatever k is). Commitments take
public points already on the device (Jacobian, Z in {0, 1}; the prover
loads the zkey's p_tau once per proof) and run the device MSM on each
party's share of the coefficients.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..ec import curve as ec
from ..ec import msm as msm_mod
from ..ff import mont
from ..ff.spec import Field
from ..mpc import chacha, rep3, shamir
from ..mpc.rng import LABEL_FIELD, draw_field


def _msm(spec, points, coeffs_mont):
    """[sum c_i P_i] over the first len(coeffs) points (device Jacobian)."""
    k = coeffs_mont.shape[0]
    pts = tuple(x[:k] for x in points)
    return msm_mod.msm(spec, pts, mont.from_mont(spec.scalar_field,
                                                 coeffs_mont))


def _to_host(spec, pts):
    """Stacked or single Jacobian point(s) -> host affine list, for the
    transcript."""
    if pts[0].dim() == spec.ops.coord_ndim:
        pts = tuple(x[None] for x in pts)
    return ec.decode_points(spec, pts, site="plonk.transcript")


class PlainPlonkDriver:
    """Single-party oracle (reference mpc/plain.rs)."""

    id = 0

    def __init__(self, field: Field, seed: int = 0, device=None):
        self.field = field
        self.device = resolve_device(device)
        self._key = torch.as_tensor(
            chacha.key_to_words(seed.to_bytes(32, "little")),
            device=self.device)
        self._ctr = 0

    def promote(self, pub):
        return pub

    def add(self, x, y):
        return mont.add(self.field, x, y)

    def sub(self, x, y):
        return mont.sub(self.field, x, y)

    def neg(self, x):
        return mont.neg(self.field, x)

    def add_public(self, x, pub):
        return mont.add(self.field, x, pub)

    def mul_public(self, x, pub):
        return mont.mul(self.field, x, pub)

    def mul(self, x, y):
        return mont.mul(self.field, x, y)

    def mul_open(self, x, y):
        return mont.mul(self.field, x, y)

    def open(self, x):
        return x

    def inv(self, x):
        return mont.inv(self.field, x)

    def rand(self, k: int):
        self._ctr += 1
        return draw_field(self._key, LABEL_FIELD, self._ctr, self.field, (k,))

    def commit_many(self, spec, points, coeff_shares):
        """MSM commitments [sum c_i * P_i] for several (points, coeffs)
        pairs; host affine points."""
        return [_to_host(spec, _msm(spec, pts, c))[0]
                for pts, c in zip(points, coeff_shares)]

    def open_many(self, x):
        return x


class Rep3PlonkDriver:
    """3-party replicated driver (reference mpc/rep3.rs)."""

    def __init__(self, field: Field, net, state: rep3.Rep3State):
        self.field = field
        self.net = net
        self.state = state
        self.id = net.id
        self.device = state.device

    def fork_channels(self, n: int) -> list["Rep3PlonkDriver"]:
        """n drivers over independent network channels + forked rng
        substreams, for concurrent protocol rounds (reference forks state
        per net in co-plonk's joined rounds, round1.rs:19). All parties
        must fork identically (same count, same order)."""
        return [Rep3PlonkDriver(self.field, ch, self.state.fork())
                for ch in self.net.channels(n)]

    def promote(self, pub):
        return rep3.promote_public(self.field, pub, self.id)

    def add(self, x, y):
        return rep3.add(self.field, x, y)

    def sub(self, x, y):
        return rep3.sub(self.field, x, y)

    def neg(self, x):
        return rep3.neg(self.field, x)

    def add_public(self, x, pub):
        return rep3.add_public(self.field, x, pub, self.id)

    def mul_public(self, x, pub):
        return rep3.mul_public(self.field, x, pub)

    def mul(self, x, y):
        return rep3.mul(self.field, x, y, self.net, self.state)

    def mul_open(self, x, y):
        local = rep3.local_mul(self.field, x, y, self.state)
        return rep3.open_additive(self.field, local, self.net, self.state)

    def open(self, x):
        return rep3.open(self.field, x, self.net)

    def inv(self, x):
        return rep3.inv(self.field, x, self.net, self.state)

    def rand(self, k: int):
        return rep3.rand(self.field, self.state, (k,))

    def commit_many(self, spec, points, coeff_shares):
        """Each party's MSM of its first summands; one broadcast opens all
        commitments (stacked)."""
        halves = [_msm(spec, pts, c.a)
                  for pts, c in zip(points, coeff_shares)]
        stacked = tuple(torch.stack([h[i] for h in halves])
                        for i in range(3))
        opened = rep3.point_open_additive(spec, stacked, self.net,
                                          self.state)
        return _to_host(spec, opened)

    def open_many(self, x):
        return rep3.open(self.field, x, self.net)


class ShamirPlonkDriver:
    """n-party Shamir driver (reference mpc/shamir.rs). Degree-t shares;
    mul = local mul to 2t + king degree-reduce."""

    def __init__(self, field: Field, net, state: shamir.ShamirState):
        self.field = field
        self.net = net
        self.state = state
        self.id = net.id
        self.device = state.device

    def fork_channels(self, n: int) -> list["ShamirPlonkDriver"]:
        """See Rep3PlonkDriver.fork_channels."""
        return [ShamirPlonkDriver(self.field, ch, self.state.fork())
                for ch in self.net.channels(n)]

    def promote(self, pub):
        return pub  # constant poly share

    def add(self, x, y):
        return mont.add(self.field, x, y)

    def sub(self, x, y):
        return mont.sub(self.field, x, y)

    def neg(self, x):
        return mont.neg(self.field, x)

    def add_public(self, x, pub):
        return mont.add(self.field, x, pub)

    def mul_public(self, x, pub):
        return mont.mul(self.field, x, pub)

    def mul(self, x, y):
        return shamir.mul(self.field, x, y, self.net, self.state)

    def mul_open(self, x, y):
        local = shamir.local_mul(self.field, x, y)  # degree-2t
        return shamir.open(self.field, local, self.net, self.state,
                           degree=2 * self.state.t)

    def open(self, x):
        return shamir.open(self.field, x, self.net, self.state)

    def inv(self, x):
        k = x.shape[0]
        r = shamir.rand(self.field, self.state, (k,), net=self.net)
        rx = self.mul_open(r, x)
        return mont.mul(self.field, r, mont.inv(self.field, rx))

    def rand(self, k: int):
        return shamir.rand(self.field, self.state, (k,), net=self.net)

    def commit_many(self, spec, points, coeff_shares):
        """Each party's MSM of its degree-t share, opened by interpolation
        in the exponent, one commitment at a time."""
        opened = [shamir.open_point(spec, _msm(spec, pts, c), self.net,
                                    self.state)
                  for pts, c in zip(points, coeff_shares)]
        return [_to_host(spec, o)[0] for o in opened]

    def open_many(self, x):
        return shamir.open(self.field, x, self.net, self.state)
