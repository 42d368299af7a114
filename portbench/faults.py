"""Faults planted in the program underneath a run, for the control and the
tests that show the check fails when the timed path is broken. Each is
installed after set-up and before the warm-up, and `install` returns the
function that removes it.

  control      every MSM computes with its scalars' lowest 16-bit limb
               cleared: arithmetic that is not exact, the guarantee the
               configurations state (no model here, so no lower precision
               to fall to; this is its nearest kin);
  stale        a step returns its state unchanged: the prover (proof
               cells) or msm() (the MSM cell) returns its first result
               again;
  half_batch   msm() takes the first half of its points and scalars;
  no_exchange  the parties' point opens leave out the exchange: each
               returns its own additive share (proof cells);
  altered      the answer is altered where it is produced: the proof's
               first element (proof cells), the MSM's x (the MSM cell).
"""

from __future__ import annotations

import importlib

from cosnarks_tpu_torch.ec import msm as msm_mod
from cosnarks_tpu_torch.mpc import rep3

from .reference.bn254 import Q

PROOF_FAULTS = ("control", "stale", "half_batch", "no_exchange", "altered")
MSM_FAULTS = ("control", "stale", "half_batch", "altered")


def applicable(cell) -> tuple:
    return PROOF_FAULTS if cell.mix["job"] == "prove" else MSM_FAULTS


def _patch(module, name, new):
    orig = getattr(module, name)
    setattr(module, name, new(orig))
    return lambda: setattr(module, name, orig)


def _alter_proof(proof: dict) -> dict:
    out = dict(proof)
    if "a" in out:  # Groth16: A moved to -A, still on the curve
        x, y = out["a"]
        out["a"] = (x, -y % Q)
    else:  # PLONK
        out["eval_a"] = str(int(out["eval_a"]) + 1)
    return out


def install(fault: str, cell):
    if fault not in applicable(cell):
        raise ValueError(f"fault {fault!r} does not apply to {cell.name}")
    if fault == "control":
        def wrap(orig):
            def msm(spec, points, scalars_std, *a, **kw):
                low = scalars_std.clone()
                low[..., 0] = 0
                return orig(spec, points, low, *a, **kw)
            return msm
        return _patch(msm_mod, "msm", wrap)
    if fault == "half_batch":
        def wrap(orig):
            def msm(spec, points, scalars_std, *a, **kw):
                h = max(1, points[0].shape[0] // 2)
                return orig(spec, tuple(c[:h] for c in points),
                            scalars_std[:h], *a, **kw)
            return msm
        return _patch(msm_mod, "msm", wrap)
    if fault == "no_exchange":
        return _patch(rep3, "point_open_additive",
                      lambda orig: lambda spec, pt, net, state=None: pt)
    if cell.mix["job"] != "prove":  # stale / altered MSM
        def wrap(orig):
            first = []

            def msm(*a, **kw):
                out = orig(*a, **kw)
                if fault == "altered":
                    x = out[0].clone()
                    x[..., 0] = (x[..., 0] + 1) % (1 << 16)
                    return (x,) + tuple(out[1:])
                if not first:
                    first.append(out)
                return first[0]
            return msm
        return _patch(msm_mod, "msm", wrap)
    prover = importlib.import_module(
        f"cosnarks_tpu_torch.{cell.config['protocol']}.prove")
    driver_arg = 0 if cell.config["protocol"] == "groth16" else 1

    def wrap(orig):
        first = {}

        def prove(*a, **kw):
            out = orig(*a, **kw)
            if fault == "altered":
                return _alter_proof(out)
            return first.setdefault(a[driver_arg].id, out)
        return prove
    return _patch(prover, "prove", wrap)
