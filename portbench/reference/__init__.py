"""The benchmark's plain reference: BN254 arithmetic, pairings, the Groth16
and PLONK verifiers and keys, and the MSM check, in Python integers. It
imports nothing of the program under test."""
