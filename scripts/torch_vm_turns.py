"""What taking turns costs the port's 3-party Rep3 circom witness extension.

    python3 scripts/torch_vm_turns.py

Runs synthetic_zkey(2^16 - 2)'s squaring chain as circom
(groth16/setup.chain_circom, the size of chip_smoke.py's phase
rep3_circom_groth16) through vm.mpc_run.run_rep3_witness_extension on three
party threads of run_parties, three pairs of runs taking turns at going
first:

  - turns: one party computes at a time and hands the turn over in every
    recv (mpc/net/base.py Turn), as every prover runs;
  - free: each party leaves its turn and swaps in one that never waits, so
    the three party threads run as the Python interpreter schedules them.

Both recombine to the same witness, checked against the plain VM. Prints
one JSON line per run (wall seconds and each party's VM seconds) and a
summary line with the medians. The VM is host Python: the run needs no card
and builds no kernel.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cosnarks_tpu_torch.ff.spec import BN254_FR  # noqa: E402
from cosnarks_tpu_torch.groth16.setup import chain_circom  # noqa: E402
from cosnarks_tpu_torch.mpc.net.local import run_parties  # noqa: E402
from cosnarks_tpu_torch.vm import interp, lang, mpc_run, witness  # noqa: E402

CONSTRAINTS = (1 << 16) - 2
PAIRS = 3


class _Free:
    """A Turn that never waits."""

    def runnable(self):
        return contextlib.nullcontext()

    def blocked(self):
        return contextlib.nullcontext()


def main() -> int:
    field = BN254_FR
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "chain.circom")
        with open(src, "w") as fh:
            fh.write(chain_circom(CONSTRAINTS))
        prog = lang.load_program(src)
    vm = interp.WitnessVM(prog, field)
    plain = witness.witness_vector(vm, vm.run({"x": 3}))
    trees = mpc_run.split_input_tree({"x": 3}, field)

    def extend(net):
        t0 = time.perf_counter()
        wit, _, _ = mpc_run.run_rep3_witness_extension(
            prog, field, trees[net.id], net, seed=bytes([net.id + 1]) * 32)
        return wit, time.perf_counter() - t0

    def free(net):
        turn = net.turn
        with turn.blocked():  # give the shared lock back for the whole run
            net.turn = _Free()
            try:
                return extend(net)
            finally:
                net.turn = turn

    walls = {"turns": [], "free": []}
    parties = {"turns": extend, "free": free}
    for k in range(PAIRS):
        for mode in (("turns", "free") if k % 2 == 0 else ("free", "turns")):
            t0 = time.perf_counter()
            res = run_parties([parties[mode]] * 3)
            wall = time.perf_counter() - t0
            if mpc_run.combine_witnesses([r[0] for r in res],
                                         field) != plain:
                raise AssertionError(f"{mode}: witness differs from plain")
            walls[mode].append(wall)
            print(json.dumps({"mode": mode, "constraints": CONSTRAINTS,
                              "wall_s": wall,
                              "vm_s_by_party": [r[1] for r in res]}),
                  flush=True)
    med = {m: statistics.median(v) for m, v in walls.items()}
    print(json.dumps({"constraints": CONSTRAINTS, "pairs": PAIRS,
                      "median_wall_s": med,
                      "turns_over_free": med["turns"] / med["free"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
