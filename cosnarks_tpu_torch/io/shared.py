"""`.shared` artifact formats: secret-shared witnesses and inputs (port of
cosnarks_tpu.io.shared).

Role of co-circom-types (SharedWitness / Rep3SharedInput,
co-circom/co-circom-types/src/lib.rs:21-504) — the reference serializes via
bincode; the JAX package defines an explicit versioned container (same
iden3-style framing as zkey/wtns), and the port writes the same bytes.
Share values are stored in standard (non-Montgomery) form so files are
representation-agnostic. Shares read from a file land on the device the
caller names.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

from .. import resolve_device
from ..ff import mont
from ..ff.bigint import ints_to_limbs, limbs_to_int
from ..ff.spec import BLS12_381_FR, BN254_FR, Field
from ..mpc import chacha, rep3, shamir
from .binformat import (Container, le_bytes_to_limbs, limbs_to_le_bytes,
                        write_container)

PROTO_REP3 = 0
PROTO_SHAMIR = 1

_FIELDS = {BN254_FR.p: BN254_FR, BLS12_381_FR.p: BLS12_381_FR}


@dataclasses.dataclass
class SharedWitnessFile:
    protocol: int
    party_id: int
    n_parties: int
    threshold: int
    field: Field
    public_inputs: list[int]  # instance incl. leading 1
    share_a: torch.Tensor  # (n_wit, nlimbs) Montgomery (internal form)
    share_b: torch.Tensor | None  # rep3 only


def _std_bytes(field: Field, share) -> bytes:
    return limbs_to_le_bytes(mont.from_mont(field, share).cpu().numpy())


def write_shared_witness(f: SharedWitnessFile, *, seed_a: bytes | None = None,
                         seed_b: bytes | None = None,
                         count: int | None = None) -> bytes:
    """Serialize; a share half can be replaced by its 32-byte PRG seed
    (CompressedRep3SharedWitness / SeededType, co-circom-types/src/
    lib.rs:152 + mpc-core rep3.rs:138-150). Seeded halves shrink the file
    to a constant regardless of witness size; `read_shared_witness`
    re-expands them (the reference's uncompress step)."""
    field = f.field
    n8 = field.nlimbs * 2
    header = struct.pack(
        "<IIIII", f.protocol, f.party_id, f.n_parties, f.threshold, n8
    ) + limbs_to_le_bytes(np.asarray(field.p_limbs)[None, :])
    pubs = limbs_to_le_bytes(ints_to_limbs(f.public_inputs, field.nlimbs))
    sections = [
        (1, header),
        (2, struct.pack("<I", len(f.public_inputs)) + pubs),
    ]
    if seed_a is not None:
        sections.append((5, struct.pack("<I", count) + seed_a))
    else:
        sections.append((3, _std_bytes(field, f.share_a)))
    if seed_b is not None:
        sections.append((6, struct.pack("<I", count) + seed_b))
    elif f.share_b is not None:
        sections.append((4, _std_bytes(field, f.share_b)))
    version = 2 if (seed_a is not None or seed_b is not None) else 1
    return write_container(b"cosw", version, sections)


def expand_seed(field: Field, seed: bytes, count: int,
                device=None) -> torch.Tensor:
    """32-byte seed -> (count, nlimbs) Montgomery share limbs on `device`.

    Each element is 2*field-size ChaCha20 keystream bits (nonce (0, 0))
    reduced mod p (statistical distance < 2^-(bits) from uniform)."""
    device = resolve_device(device)
    kw = torch.as_tensor(chacha.key_to_words(seed), device=device)
    per = 2 * field.nlimbs
    limbs = chacha.limbs16(kw, (0, 0), count * per).cpu().numpy()
    raw = limbs.astype("<u2").tobytes()  # LE 16-bit limbs
    stride = per * 2
    vals = [
        int.from_bytes(raw[i * stride : (i + 1) * stride], "little") % field.p
        for i in range(count)
    ]
    return mont.encode(field, vals, device=device)


def read_shared_witness(data: bytes, device=None) -> SharedWitnessFile:
    """Parse a `.shared` file; its shares go to `device`."""
    device = resolve_device(device)
    c = Container(data, b"cosw")
    h = c.section(1)
    protocol, party_id, n_parties, threshold, n8 = struct.unpack_from(
        "<IIIII", h, 0
    )
    prime = limbs_to_int(le_bytes_to_limbs(h[20 : 20 + n8], n8)[0])
    field = _FIELDS[prime]
    pub_sec = c.section(2)
    (npub,) = struct.unpack_from("<I", pub_sec, 0)
    pubs = [
        limbs_to_int(r) for r in le_bytes_to_limbs(pub_sec[4:], n8)[:npub]
    ]

    def load_half(raw_sec: int, seed_sec: int):
        if raw_sec in c.sections:
            limbs = le_bytes_to_limbs(c.section(raw_sec), n8)
            return mont.to_mont(field, torch.as_tensor(
                limbs.astype(np.int64), device=device))
        if seed_sec in c.sections:
            body = c.section(seed_sec)
            (count,) = struct.unpack_from("<I", body, 0)
            return expand_seed(field, bytes(body[4:36]), count, device)
        return None

    share_a = load_half(3, 5)
    share_b = load_half(4, 6)
    return SharedWitnessFile(
        protocol, party_id, n_parties, threshold, field, pubs, share_a, share_b
    )


def split_witness_rep3(field: Field, witness: list[int], n_instance: int,
                       rng, seeded: bool = False,
                       device=None) -> list[bytes]:
    """Full wtns vector -> 3 rep3 .shared files (reference split_witness,
    co-circom/src/lib.rs:46-80).

    seeded=True emits compressed files: additive summands x0, x1 come from
    32-byte ChaCha seeds, only x2 = w - x0 - x1 is stored raw. Party 1's
    file is constant-size; parties 0/2 store one vector instead of two
    (CompressedRep3SharedWitness, co-circom-types/src/lib.rs:152)."""
    device = resolve_device(device)
    pubs = witness[:n_instance]
    secret = witness[n_instance:]
    if not seeded:
        shares = rep3.share_field_elements(field, secret, rng, device=device)
        return [
            write_shared_witness(
                SharedWitnessFile(PROTO_REP3, i, 3, 1, field, pubs, s.a, s.b)
            )
            for i, s in enumerate(shares)
        ]
    count = len(secret)
    s0 = rng.randbytes(32)
    s1 = rng.randbytes(32)
    x0 = expand_seed(field, s0, count, device)
    x1 = expand_seed(field, s1, count, device)
    w = mont.encode(field, secret, device=device)
    x2 = mont.sub(field, mont.sub(field, w, x0), x1)
    # party i holds (a=x_i, b=x_{i+1})
    mk = SharedWitnessFile
    return [
        write_shared_witness(
            mk(PROTO_REP3, 0, 3, 1, field, pubs, x0, x1),
            seed_a=s0, seed_b=s1, count=count,
        ),
        write_shared_witness(
            mk(PROTO_REP3, 1, 3, 1, field, pubs, x1, x2),
            seed_a=s1, count=count,
        ),
        write_shared_witness(
            mk(PROTO_REP3, 2, 3, 1, field, pubs, x2, x0),
            seed_b=s0, count=count,
        ),
    ]


def split_witness_shamir(field: Field, witness: list[int], n_instance: int,
                         n: int, t: int, rng, device=None) -> list[bytes]:
    pubs = witness[:n_instance]
    shares = shamir.share_values(field, witness[n_instance:], n, t, rng,
                                 device=resolve_device(device))
    return [
        write_shared_witness(
            SharedWitnessFile(PROTO_SHAMIR, i, n, t, field, pubs, s, None)
        )
        for i, s in enumerate(shares)
    ]


# -- shared input files (JSON; witness-extension inputs) --------------------

def split_input_rep3(field: Field, inputs: dict, rng,
                     public_keys: set[str] = frozenset(),
                     device=None) -> list[str]:
    """input.json dict (name -> int | [int...]) -> 3 per-party JSON strings
    (the reference's Rep3SharedInput, co-circom-types lib.rs:207+)."""
    device = resolve_device(device)
    outs = [{} for _ in range(3)]
    for name, value in inputs.items():
        flat = value if isinstance(value, list) else [value]
        flat = [int(v) for v in flat]
        if name in public_keys:
            for o in outs:
                o[name] = {
                    "kind": "public",
                    "values": [str(v) for v in flat],
                    "shape": "list" if isinstance(value, list) else "scalar",
                }
        else:
            shares = rep3.share_field_elements(field, flat, rng,
                                               device=device)
            for i, o in enumerate(outs):
                a = mont.decode(field, shares[i].a)
                b = mont.decode(field, shares[i].b)
                o[name] = {
                    "kind": "shared",
                    "a": [str(v) for v in a],
                    "b": [str(v) for v in b],
                    "shape": "list" if isinstance(value, list) else "scalar",
                }
    return [json.dumps(o, indent=1) for o in outs]


def merge_input_shares(parts: list[str]) -> str:
    """Merge input shares from multiple providers into one per-party file,
    checking public-input consistency (reference merge_input_shares)."""
    merged = {}
    for part in parts:
        d = json.loads(part)
        for name, entry in d.items():
            if name in merged:
                if merged[name] != entry:
                    raise ValueError(
                        f"inconsistent duplicate input '{name}' during merge"
                    )
            else:
                merged[name] = entry
    return json.dumps(merged, indent=1)
