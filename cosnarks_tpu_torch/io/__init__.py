"""Artifact types and formats: snarkjs zkey / wtns / r1cs containers,
circom .sym files, snarkjs JSON and the .shared share files."""
