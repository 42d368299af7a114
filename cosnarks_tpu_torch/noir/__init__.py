"""coNoir stack of the port: ACIR artifacts, the co-ACVM solver and the
Brillig VM (host Python, as in `cosnarks_tpu.noir`).

_msgpack.py      — the msgpack subset ACIR uses (no `msgpack` package)
acir.py          — Noir .json artifact + witness-stack parsing, ABI encoding
brillig.py       — the unconstrained-function VM over the driver seam
blackbox_hash.py — SHA-256 / Blake / AES black boxes, plain and Rep3
solver.py        — the ACVM opcode solver, generic over the VM driver seam
"""
