"""The coNoir CLI's two co-proof stages at 2^16 rows, at once and one
after the other, in one call on one card: chip_smoke.py's `cli_tcp_noir`
runs them at once, and this script measures what that costs each.

Builds the kernels, writes the smoke's Noir program
(`noir.synthetic.SMOKE_PROGRAM`) and its plain witness stack, splits the
proving key for REP3 and for SHAMIR (`split-proving-key`), then runs
three `generate-proof --protocol REP3` processes over TLS
(examples/configs/tls) and three `--protocol SHAMIR` ones over plaintext
TCP, first all six at once, then REP3 and SHAMIR one after the other. It
prints (and writes to chiprun_out/noir_cli_overlap.jsonl) the card, each
order's wall seconds and each process's seconds and "Generate proof"
milliseconds, and whether all twelve proof files are equal. One H100,
about nine minutes; imports nothing of JAX.

    python3 scripts/torch_noir_cli_overlap.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_noir_cli_overlap: no CUDA device", file=sys.stderr)
        return 2
    from cosnarks_tpu_torch import _build
    from cosnarks_tpu_torch.honk import polyops
    from cosnarks_tpu_torch.noir import acir, solver, synthetic
    from cosnarks_tpu_torch.vm.interp import PlainDriver
    from torch_cli_procs import party_configs, run_cli

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out = open(os.path.join(out_dir, "noir_cli_overlap.jsonl"), "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()})
    t0 = time.perf_counter()
    _build.build()
    emit({"build_s": time.perf_counter() - t0})
    program = synthetic.SMOKE_PROGRAM
    noir = "cosnarks_tpu_torch.noir"
    tls_dir = os.path.join(ROOT, "examples", "configs", "tls")
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        acir.dump_artifact(path("program.json"),
                           *synthetic.synthetic_program(**program))
        art = acir.load_artifact(path("program.json"))
        inputs = synthetic.synthetic_inputs(program["n_inputs"], 0x401)
        acir.write_witness_stack(path("witness.gz"), solver.solve_program(
            art, PlainDriver(polyops.FR), polyops.R, inputs))
        given = ["--circuit", path("program.json"), "--witness",
                 path("witness.gz")]
        t0 = time.perf_counter()
        run_cli([["split-proving-key", *given, "--out-dir", path(p),
                  "--protocol", p] for p in ("REP3", "SHAMIR")], tmp,
                "split", module=noir)
        emit({"split_s": time.perf_counter() - t0})

        def argvs(proto, configs, tag):
            return [["generate-proof", "--protocol", proto, "--proving-key",
                     path(f"{proto}/pk.{i}.shared"), "--proving-key-public",
                     path(f"{proto}/pk_public.npz"), "--config", configs[i],
                     "--out", path(f"{tag}{proto}.proof.{i}"),
                     "--public-input", path(f"{tag}{proto}.public.{i}"),
                     "--hasher", "KECCAK"] for i in range(3)]

        def summary(runs):
            return {"process_s": [r["seconds"] for r in runs],
                    "prove_ms": [r["phases_ms"].get("Generate proof")
                                 for r in runs]}

        t0 = time.perf_counter()
        runs = run_cli(
            argvs("REP3", party_configs(tmp, "tls_a", tls_dir), "a")
            + argvs("SHAMIR", party_configs(tmp, "tcp_a", None), "a"),
            tmp, "at once", module=noir)
        emit({"order": "at once", "wall_s": time.perf_counter() - t0,
              "REP3": summary(runs[:3]), "SHAMIR": summary(runs[3:])})
        t0 = time.perf_counter()
        rep3 = run_cli(argvs("REP3", party_configs(tmp, "tls_b", tls_dir),
                             "b"), tmp, "REP3", module=noir)
        shamir = run_cli(argvs("SHAMIR", party_configs(tmp, "tcp_b", None),
                               "b"), tmp, "SHAMIR", module=noir)
        emit({"order": "one after the other",
              "wall_s": time.perf_counter() - t0, "REP3": summary(rep3),
              "SHAMIR": summary(shamir)})
        proofs = set()
        for tag in "ab":
            for proto in ("REP3", "SHAMIR"):
                for i in range(3):
                    with open(path(f"{tag}{proto}.proof.{i}"), "rb") as fh:
                        proofs.add(fh.read())
    emit({"all_proofs_equal": len(proofs) == 1})
    return 0 if len(proofs) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
