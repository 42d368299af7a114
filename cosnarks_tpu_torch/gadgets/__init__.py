"""MPC gadgets (Poseidon2 permutation, Merkle trees) — reference
mpc-core/src/gadgets/."""
