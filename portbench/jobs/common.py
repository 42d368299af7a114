"""What the jobs share: inputs drawn from the run's seed, and the 3-party
Rep3 proof over the program's in-process network."""

from __future__ import annotations

import hashlib

import torch

from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties

from .. import hooks

PARTY_TIMEOUT_S = 600.0


def seed_bytes(seed: int, tag: bytes) -> bytes:
    """The bytes from which the program draws an input of this run."""
    return b"portbench:%d:" % seed + tag


def draw(seed: int, tag: bytes, p: int) -> int:
    h = hashlib.blake2b(seed_bytes(seed, tag), digest_size=32).digest()
    return int.from_bytes(h, "big") % p


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rep3_round(seed: int, k: int, device, prove_party, counters, wanted):
    """One 3-party Rep3 job: each party (a thread over the program's
    LocalNetwork, the parties taking turns on the card) sets up its PRF
    state from this run's seed and job index k and returns
    `prove_party(net, state, timings)`. With `mpc_sends` wanted, counts each
    party's sends; with `party_timings`, passes each a timings dict. Returns
    the parties' outputs, after the card is done."""
    def party(net):
        tally = {}
        if "mpc_sends" in wanted:
            hooks.count_sends(net, tally)
        timings = {} if "party_timings" in wanted else None
        state = rep3.Rep3State.setup(
            net, seed_bytes(seed, b"prf:%d:%d" % (k, net.id)), device=device)
        out = prove_party(net, state, timings)
        sync(device)
        return out, tally, timings

    res = run_parties([party] * 3, timeout=PARTY_TIMEOUT_S)
    if counters is not None:
        with counters.lock:
            counters.sends.extend(t for _, t, _ in res if t)
            counters.timings.extend(t for _, _, t in res if t is not None)
    return [out for out, _, _ in res]


def _signature(proof: dict) -> tuple:
    return tuple(sorted(map(repr, proof.items())))


def check_proofs(outputs, warm, verify) -> list[bool]:
    """A flag a job: its parties returned the same proof, the proof is not
    one the run made before (the warm-up's included: every proof draws
    fresh randomness), and `verify(proof)` accepts it."""
    seen = {_signature(o[0]) for o in warm}
    ok = []
    for proofs in outputs:
        sig = _signature(proofs[0])
        fresh = sig not in seen
        seen.add(sig)
        ok.append(all(p == proofs[0] for p in proofs) and fresh
                  and verify(proofs[0]))
    return ok
