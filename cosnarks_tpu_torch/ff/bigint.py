"""Host-side big-integer <-> limb conversions and a pure-Python modular oracle.

These helpers are the ground truth the device limb kernels are tested
against (the role arkworks `ark-ff` plays for co-snarks). Everything here is
host-only numpy / Python int code; copied from the JAX package so the port
imports nothing of it.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, nlimbs: int) -> np.ndarray:
    """Little-endian 16-bit limbs of ``x`` as uint32 (values < 2**16)."""
    if x < 0:
        raise ValueError("negative")
    out = np.empty(nlimbs, dtype=np.uint32)
    for i in range(nlimbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in nlimbs limbs")
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of :func:`int_to_limbs`; accepts any integer array-like."""
    x = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(arr[..., i])
    return x


def ints_to_limbs(xs, nlimbs: int) -> np.ndarray:
    """Vectorized ``int_to_limbs`` over a list of python ints -> (len, nlimbs),
    through one little-endian byte string (a Python loop over limbs costs
    seconds at proving-key sizes)."""
    nbytes = nlimbs * LIMB_BITS // 8
    try:
        buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    except OverflowError as exc:
        raise ValueError(f"value does not fit in {nlimbs} limbs or is "
                         "negative") from exc
    return (np.frombuffer(buf, dtype="<u2").reshape(len(xs), nlimbs)
            .astype(np.uint32))


def limbs_to_ints(arr) -> list[int]:
    """(..., nlimbs) limb array -> flat list of python ints (row-major)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1, arr.shape[-1])
    if flat.size and (flat.min() < 0 or flat.max() > LIMB_MASK):
        return [limbs_to_int(row) for row in flat]
    raw = flat.astype("<u2").tobytes()
    step = 2 * flat.shape[-1]
    return [int.from_bytes(raw[i:i + step], "little")
            for i in range(0, len(raw), step)]
