"""UltraHonk proof system (the coNoir proving stack) of the port.

PyTorch port of cosnarks_tpu.honk, the Barretenberg-compatible UltraHonk
prover/verifier of the reference's ultrahonk / co-noir-common crates.
Host Python as in the JAX package: the transcript, the builder and its
gadgets, the proving-key construction and the verifier. On the device,
as (n, 16) Montgomery limb tensors: the prover's vector algebra (oink,
sumcheck, Gemini / Shplonk / KZG) and the KZG commitments (`msm()`).

- transcript: Fiat-Shamir transcript, Poseidon2Sponge + Keccak256 flavors
- crs: Barretenberg CRS .dat parsing + local known-tau generation
- polyops: host scalar helpers and tensor polynomial helpers, commit
- builder / builder_gadgets / field_ct: UltraCircuitBuilder
- proving_key: ACIR trace -> proving / verifying keys
- relations: the 9 Ultra relation families / 28 subrelations
- prover / verifier: oink + sumcheck + shplemini/KZG
- co_driver / co_prover: the Rep3 collaborative prover
"""
