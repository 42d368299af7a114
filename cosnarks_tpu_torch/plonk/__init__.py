"""Collaborative snarkjs-compatible PLONK (port of cosnarks_tpu.plonk).

prove.py  — the 5-round prover, generic over the driver seam
drivers.py — plain / Rep3 / Shamir protocol drivers (whole-vector ops)
verify.py — snarkjs verification_key.json verifier
"""
