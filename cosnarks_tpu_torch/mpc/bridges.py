"""Share-translation bridges between protocols (port of
cosnarks_tpu.mpc.bridges).

A Rep3 additive component x_i divided by the i-th degree-2t Lagrange
coefficient is a valid degree-2t Shamir share of the same secret
(x = sum_i lam_i * (x_i/lam_i)); one degree reduction yields fresh degree-t
shares.
"""

from __future__ import annotations

import torch

from ..ec import curve as ec
from ..ff import mont
from ..ff.bigint import int_to_limbs
from ..ff.spec import Field
from . import shamir
from .rep3 import Share as Rep3Share


def _check_rep3_shape(state: shamir.ShamirState):
    if state.n != 3 or state.t != 1:
        raise ValueError("rep3->shamir bridge requires n=3, t=1")


def translate_rep3_to_shamir(field: Field, rep3_share: Rep3Share, net,
                             state: shamir.ShamirState):
    """Rep3 replicated share -> degree-t Shamir share (3 parties, t=1).

    One communication round (the king degree reduction)."""
    _check_rep3_shape(state)
    lam = shamir.lagrange_at_zero(field, [0, 1, 2])[state.id]
    lam_inv = mont.constant(field, pow(lam, -1, field.p),
                            device=rep3_share.a.device)
    y = mont.mul(field, rep3_share.a, lam_inv)  # valid degree-2 share
    return shamir.degree_reduce(field, y, net, state)


def translate_rep3_point_to_shamir(spec, rep3_point, net,
                                   state: shamir.ShamirState):
    """Rep3 replicated EC point share -> degree-t Shamir point share: scale
    the additive component by the inverse Lagrange coefficient, then one
    king point degree-reduction round."""
    _check_rep3_shape(state)
    f = spec.scalar_field
    lam = shamir.lagrange_at_zero(f, [0, 1, 2])[state.id]
    pt = rep3_point.a if hasattr(rep3_point, "a") else rep3_point
    batched = pt[0].ndim > spec.ops.coord_ndim
    if not batched:
        pt = tuple(x[None] for x in pt)
    k = torch.as_tensor(int_to_limbs(pow(lam, -1, f.p), f.nlimbs)
                        .astype("int64"), device=pt[0].device)
    y = ec.scalar_mul(spec, pt, k.expand(pt[0].shape[0], f.nlimbs))
    if not batched:
        y = tuple(x[0] for x in y)  # a valid degree-2 point share
    return shamir.degree_reduce_point(spec, y, net, state)
