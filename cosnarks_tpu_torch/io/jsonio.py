"""snarkjs JSON artifact formats: proof.json / public.json /
verification_key.json (decimal-string coordinates, projective with Z=1);
copy of cosnarks_tpu.io.jsonio."""

from __future__ import annotations

import json


def g1_to_json(pt):
    if pt is None:
        return ["0", "1", "0"]
    return [str(pt[0]), str(pt[1]), "1"]


def g2_to_json(pt):
    if pt is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [
        [str(pt[0][0]), str(pt[0][1])],
        [str(pt[1][0]), str(pt[1][1])],
        ["1", "0"],
    ]


def g1_from_json(v):
    x, y, z = (int(c) for c in v)
    if z == 0:
        return None
    if z != 1:
        raise ValueError("non-normalized G1 json point")
    return (x, y)


def g2_from_json(v):
    (x0, x1), (y0, y1) = (int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1]))
    z = (int(v[2][0]), int(v[2][1]))
    if z == (0, 0):
        return None
    if z != (1, 0):
        raise ValueError("non-normalized G2 json point")
    return ((x0, x1), (y0, y1))


def proof_to_json(proof, curve_name="bn128", protocol="groth16") -> str:
    return json.dumps(
        {
            "pi_a": g1_to_json(proof["a"]),
            "pi_b": g2_to_json(proof["b"]),
            "pi_c": g1_to_json(proof["c"]),
            "protocol": protocol,
            "curve": curve_name,
        },
        indent=1,
    )


def proof_from_json(s: str):
    d = json.loads(s)
    return {
        "a": g1_from_json(d["pi_a"]),
        "b": g2_from_json(d["pi_b"]),
        "c": g1_from_json(d["pi_c"]),
        "protocol": d.get("protocol", "groth16"),
        "curve": d.get("curve", "bn128"),
    }


def public_to_json(values) -> str:
    return json.dumps([str(v) for v in values], indent=1)


def public_from_json(s: str):
    return [int(v) for v in json.loads(s)]


def vkey_from_json(s: str):
    d = json.loads(s)
    return {
        "protocol": d["protocol"],
        "curve": d["curve"],
        "n_public": d["nPublic"],
        "alpha_g1": g1_from_json(d["vk_alpha_1"]),
        "beta_g2": g2_from_json(d["vk_beta_2"]),
        "gamma_g2": g2_from_json(d["vk_gamma_2"]),
        "delta_g2": g2_from_json(d["vk_delta_2"]),
        "ic": [g1_from_json(p) for p in d["IC"]],
    }


def vkey_to_json(vk) -> str:
    return json.dumps(
        {
            "protocol": vk.get("protocol", "groth16"),
            "curve": vk.get("curve", "bn128"),
            "nPublic": vk["n_public"],
            "vk_alpha_1": g1_to_json(vk["alpha_g1"]),
            "vk_beta_2": g2_to_json(vk["beta_g2"]),
            "vk_gamma_2": g2_to_json(vk["gamma_g2"]),
            "vk_delta_2": g2_to_json(vk["delta_g2"]),
            "IC": [g1_to_json(p) for p in vk["ic"]],
        },
        indent=1,
    )
