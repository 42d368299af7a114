"""Collaborative Groth16 prover, snarkjs-compatible (port of
cosnarks_tpu.groth16.prove).

Witness map -> 5 MSMs over additive half-shares -> 2 communication rounds
(open A / [r]*B, then open C / open B). The prover is generic over a driver
(drivers.py), so the plain and Rep3 paths share all kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ec import curve as ec
from ..ec import host
from ..ec.curves import BN254_G1, BN254_G2, BLS12_381_G1, BLS12_381_G2
from ..ff.spec import BN254_FR
from ..io.zkey import Groth16Zkey, g1_to_ints, g2_to_ints
from ..utils import timing
from . import drivers as drv
from .witness_map import witness_map


@dataclasses.dataclass
class SharedWitness:
    """public_inputs includes the leading constant-1 wire."""

    public_inputs: list[int]
    witness: object  # driver share form, (n_vars - n_public - 1, nlimbs)


def curve_specs_for(zkey: Groth16Zkey):
    if zkey.fr is BN254_FR or zkey.fr.name == "bn254_fr":
        return BN254_G1, BN254_G2
    return BLS12_381_G1, BLS12_381_G2


def _load_array(spec, arr: np.ndarray, device):
    """(N, 2, ...) zkey Montgomery limbs -> Jacobian points on `device`
    (all-zero rows are infinity)."""
    with timing.blocking("groth16.load_points", syncs=2):
        t = torch.as_tensor(arr.astype(np.int64), device=device)
        inf = torch.as_tensor(
            np.all(arr.reshape(arr.shape[0], -1) == 0, axis=1),
            device=device)
    X, Y = t[:, 0], t[:, 1]
    n = arr.shape[0]
    one = spec.ops.one((n,), device=device)
    Z = spec.ops.select(inf, spec.ops.zeros((n,), device=device), one)
    return (X, Y, Z)


def load_g1_array(spec, arr: np.ndarray, device):
    """(N, 2, nl) zkey limbs -> Jacobian G1 points."""
    return _load_array(spec, arr, device)


def load_g2_array(spec, arr: np.ndarray, device):
    """(N, 2, 2, nl) -> Jacobian G2 points ((..., 2, nl) Fq2 coords)."""
    return _load_array(spec, arr, device)


def _point_to_host(spec, pt):
    return ec.decode_points(spec, tuple(x[None] for x in pt),
                            site="groth16.proof")[0]


def _combine_public(driver, spec, res, query0, vk_param, pub_pts, pub_vals):
    """Add the public part query[0] + vk_param + sum query[1..]*pub
    (computed on the host) through the driver (party 0 only for additive
    shares)."""
    hc = host.host_curve(spec)
    pub_acc = hc.msm([hc.lift_affine(p) for p in pub_pts], pub_vals)
    combined = hc.add(hc.add(hc.lift_affine(query0),
                             hc.lift_affine(vk_param)), pub_acc)
    dev_pt = tuple(x[0] for x in ec.encode_points(
        spec, [hc.affine_ints(combined)], device=res[0].device))
    return driver.add_public_point(spec, res, dev_pt)


class _Clock:
    """The prover's phases as spans `prove.<phase>` (`timing.Timer`), one
    after another from the clock's start. With a `timings` dict, each
    phase's self seconds (the party's own, its turn held) add to
    timings[phase] and the rest, the party's turn waits, to
    timings["turn_wait"]; only then is the device synchronised at each
    phase's end. Without one, the spans are made while `timing` records."""

    def __init__(self, timings, device):
        self.timings = timings
        self.device = device
        self.timer = self._start()

    def _start(self):
        if self.timings is None and not timing.on():
            return None
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return timing.Timer()

    def lap(self, name):
        if self.timer is None:  # neither timed nor recorded so far
            self.timer = self._start()
            return
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dur, own = self.timer.stop("prove." + name)
        if self.timings is not None:
            t = self.timings
            t[name] = t.get(name, 0.0) + own * 1e-9
            t["turn_wait"] = t.get("turn_wait", 0.0) + (dur - own) * 1e-9
        self.timer = timing.Timer()


def prove(driver, zkey: Groth16Zkey, witness: SharedWitness,
          timings: dict | None = None) -> dict:
    """Produce a snarkjs-compatible Groth16 proof dict {a, b, c} (host ints).

    Rounds (Rep3; PRF setup done in driver.state):
      1. open(A) and reshare+[r]*B_g1
      2. open(C) and open(B_g2)
    `timings`, when given, receives each phase's self seconds (witness_map,
    g1_msm, g2_msm, rounds: the party's own, with its turn held) and under
    "turn_wait" the seconds the party waited for its turn inside them;
    together they are the call's wall time."""
    fr = zkey.fr
    fq = zkey.fq
    g1, g2 = curve_specs_for(zkey)
    dev = driver.device
    clock = _Clock(timings, dev)

    n_instance = zkey.n_public + 1
    if len(witness.public_inputs) != n_instance:
        raise ValueError("public input count mismatch")

    w = driver.full_witness(fr, witness.public_inputs, witness.witness)
    h_half = witness_map(driver, zkey, w)
    clock.lap("witness_map")

    r = driver.rand(fr)
    s = driver.rand(fr)

    aux_half = driver.to_half(witness.witness)

    a_query = load_g1_array(g1, zkey.a_query, dev)
    b_g1_query = load_g1_array(g1, zkey.b_g1_query, dev)
    b_g2_query = load_g2_array(g2, zkey.b_g2_query, dev)
    l_query = load_g1_array(g1, zkey.c_query, dev)
    h_query = load_g1_array(g1, zkey.h_query, dev)

    delta_g1 = tuple(x[0] for x in ec.encode_points(
        g1, [g1_to_ints(fq, zkey.delta_g1)], device=dev))
    delta_g2 = tuple(x[0] for x in ec.encode_points(
        g2, [g2_to_ints(fq, zkey.delta_g2)], device=dev))
    alpha_g1 = g1_to_ints(fq, zkey.alpha_g1)
    beta_g1 = g1_to_ints(fq, zkey.beta_g1)
    beta_g2 = g2_to_ints(fq, zkey.beta_g2)

    def slice_pts(pts, lo):
        return tuple(x[lo:] for x in pts)

    pub_vals = witness.public_inputs[1:]
    pub_g1 = [[g1_to_ints(fq, q[i]) for i in range(1, n_instance)]
              for q in (zkey.a_query, zkey.b_g1_query)]
    pub_g2 = [g2_to_ints(fq, zkey.b_g2_query[i])
              for i in range(1, n_instance)]

    r_half = driver.rand_to_half(r)
    s_half = driver.rand_to_half(s)
    # A = [r]*delta + a_query . w  (+ alpha)
    r_delta = drv.scalar_mul_public_point(g1, delta_g1, r_half)
    g_a = ec.add(g1, r_delta, drv.msm_half(
        g1, slice_pts(a_query, n_instance), aux_half))
    g_a = _combine_public(driver, g1, g_a, g1_to_ints(fq, zkey.a_query[0]),
                          alpha_g1, pub_g1[0], pub_vals)
    # B in G1 (needed for C)
    s_delta_g1 = drv.scalar_mul_public_point(g1, delta_g1, s_half)
    g1_b = ec.add(g1, s_delta_g1, drv.msm_half(
        g1, slice_pts(b_g1_query, n_instance), aux_half))
    g1_b = _combine_public(driver, g1, g1_b,
                           g1_to_ints(fq, zkey.b_g1_query[0]), beta_g1,
                           pub_g1[1], pub_vals)
    clock.lap("g1_msm")
    # B in G2
    s_delta_g2 = drv.scalar_mul_public_point(g2, delta_g2, s_half)
    g2_b = ec.add(g2, s_delta_g2, drv.msm_half(
        g2, slice_pts(b_g2_query, n_instance), aux_half))
    g2_b = _combine_public(driver, g2, g2_b,
                           g2_to_ints(fq, zkey.b_g2_query[0]), beta_g2,
                           pub_g2, pub_vals)
    clock.lap("g2_msm")

    l_acc = drv.msm_half(g1, l_query, aux_half)
    h_acc = drv.msm_half(g1, h_query, h_half)

    rs_half = driver.local_mul_scalar(fr, r, s)
    r_s_delta_g1 = drv.scalar_mul_public_point(g1, delta_g1, rs_half)
    clock.lap("g1_msm")

    # round 1: open A ; [r] * B_g1 (reshare + local scalar mul)
    g_a_opened = driver.open_half_point(g1, g_a)
    r_g1_b = driver.scalar_mul_half_point(g1, g1_b, r)

    s_g_a = drv.scalar_mul_public_point(g1, g_a_opened, s_half)
    g_c = ec.add(g1, s_g_a, r_g1_b)
    g_c = ec.add(g1, g_c, ec.neg(g1, r_s_delta_g1))
    g_c = ec.add(g1, g_c, l_acc)
    g_c = ec.add(g1, g_c, h_acc)

    # round 2: open C and B_g2
    g_c_opened = driver.open_half_point(g1, g_c)
    g2_b_opened = driver.open_half_point(g2, g2_b)
    a = _point_to_host(g1, g_a_opened)
    b = _point_to_host(g2, g2_b_opened)
    c = _point_to_host(g1, g_c_opened)
    clock.lap("rounds")

    return {
        "a": a,
        "b": b,
        "c": c,
        "protocol": "groth16",
        "curve": "bn128" if fr is BN254_FR else "bls12381",
    }


def vk_from_zkey(zkey: Groth16Zkey) -> dict:
    return {
        "protocol": "groth16",
        "curve": "bn128" if zkey.fr is BN254_FR else "bls12381",
        "n_public": zkey.n_public,
        "alpha_g1": g1_to_ints(zkey.fq, zkey.alpha_g1),
        "beta_g2": g2_to_ints(zkey.fq, zkey.beta_g2),
        "gamma_g2": g2_to_ints(zkey.fq, zkey.gamma_g2),
        "delta_g2": g2_to_ints(zkey.fq, zkey.delta_g2),
        "ic": [g1_to_ints(zkey.fq, p) for p in zkey.ic],
    }
