"""Carry state across from numpy (the JAX package's host form) to the port.

The port imports nothing of the JAX package; these functions take plain
numpy arrays / objects with the same fields, so tests can feed both packages
the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .ff import spec as _spec
from .io.zkey import Groth16Zkey, PlonkZkey
from .mpc.rep3 import Share

_FIELDS = {f.name: f for f in (_spec.BN254_FR, _spec.BN254_FQ,
                               _spec.BLS12_381_FR, _spec.BLS12_381_FQ)}


def limbs_from_numpy(arr, device=None) -> torch.Tensor:
    """Any limb array (uint32 / int) -> int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(arr).astype(np.int64),
                           device=resolve_device(device))


def share_from_numpy(a, b, device=None) -> Share:
    """A Rep3 share held as two numpy limb arrays -> the port's Share."""
    return Share(limbs_from_numpy(a, device), limbs_from_numpy(b, device))


def _copy(value):
    """numpy arrays copied, tuples / lists of them copied element-wise."""
    if isinstance(value, np.ndarray):
        return np.array(value)
    if isinstance(value, (tuple, list)):
        return type(value)(_copy(v) for v in value)
    return value


def _zkey_from_numpy(cls, zkey):
    kwargs = {}
    for field in cls.__dataclass_fields__:
        value = getattr(zkey, field)
        kwargs[field] = (_FIELDS[value.name] if field in ("fq", "fr")
                         else _copy(value))
    return cls(**kwargs)


def zkey_from_numpy(zkey) -> Groth16Zkey:
    """An object with the Groth16Zkey fields (the JAX package's zkey: numpy
    arrays and Field objects) -> the port's Groth16Zkey with the port's own
    Field objects."""
    return _zkey_from_numpy(Groth16Zkey, zkey)


def plonk_zkey_from_numpy(zkey) -> PlonkZkey:
    """An object with the PlonkZkey fields (the JAX package's parsed PLONK
    zkey) -> the port's PlonkZkey with the port's own Field objects."""
    return _zkey_from_numpy(PlonkZkey, zkey)


def honk_proving_key_from_numpy(pk, device=None):
    """An object with the UltraHonk ProvingKey fields (the JAX package's
    proving key: its polynomials lists or numpy arrays of python ints, or
    (n, 16) uint32 Montgomery limb arrays) -> the port's ProvingKey with
    every polynomial an (n, 16) int64 Montgomery limb tensor on `device`."""
    import dataclasses

    from .honk import polyops
    from .honk.proving_key import ActiveRegionData, ProvingKey

    dev = resolve_device(device)
    polys = {}
    for name, col in pk.polynomials.items():
        arr = np.asarray(col)
        if arr.ndim == 2:
            polys[name] = limbs_from_numpy(arr, dev)
        else:
            polys[name] = polyops.encode([int(v) for v in col], dev)
    kwargs = {f.name: _copy(getattr(pk, f.name))
              for f in dataclasses.fields(ProvingKey)}
    kwargs["polynomials"] = polys
    kwargs["public_inputs"] = [int(v) for v in pk.public_inputs]
    active = pk.active_region_data
    kwargs["active_region_data"] = ActiveRegionData(
        [tuple(r) for r in active.ranges], list(active.idxs))
    return ProvingKey(**kwargs)


def honk_crs_from_numpy(crs, device=None):
    """An object with the UltraHonk Crs fields (host affine monomials and
    g2_x) -> the port's Crs; with `device`, its monomials also held there
    as Jacobian tensors (commitments then run msm())."""
    from .honk.crs import Crs

    out = Crs([None if pt is None else (int(pt[0]), int(pt[1]))
               for pt in crs.monomials],
              tuple(tuple(int(c) for c in xy) for xy in crs.g2_x))
    return out if device is None else out.to(device)
