"""Plain Groth16 verifier (host-side, snarkjs-compatible), BN254 and
BLS12-381: one small IC MSM + a 4-pairing product check in python ints."""

from __future__ import annotations

from ..ec import curves, host
from ..pairing import bls12_381, bn254


def _verify(pairing_mod, g1_spec, vk, proof, public_inputs) -> bool:
    if len(public_inputs) != vk["n_public"]:
        return False
    g1 = host.host_curve(g1_spec)
    acc = g1.lift_affine(vk["ic"][0])
    for ic_pt, x in zip(vk["ic"][1:], public_inputs):
        acc = g1.add(acc, g1.mul(g1.lift_affine(ic_pt), x))
    vk_x = g1.affine_ints(acc)

    return pairing_mod.pairing_product_is_one(
        [
            (pairing_mod.g1_neg(proof["a"]), proof["b"]),
            (vk["alpha_g1"], vk["beta_g2"]),
            (vk_x, vk["gamma_g2"]),
            (proof["c"], vk["delta_g2"]),
        ]
    )


def verify_bn254(vk: dict, proof: dict, public_inputs: list[int]) -> bool:
    """Checks e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1."""
    return _verify(bn254, curves.BN254_G1, vk, proof, public_inputs)


def verify_bls12_381(vk: dict, proof: dict, public_inputs: list[int]) -> bool:
    """The same check over BLS12-381."""
    return _verify(bls12_381, curves.BLS12_381_G1, vk, proof, public_inputs)


def verify(vk: dict, proof: dict, public_inputs: list[int]) -> bool:
    """Curve-dispatching Groth16 verification (snarkjs vkey dicts)."""
    if vk.get("curve") in ("bls12381", "bls12-381"):
        return verify_bls12_381(vk, proof, public_inputs)
    return verify_bn254(vk, proof, public_inputs)
