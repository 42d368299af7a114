#!/usr/bin/env python3
"""Three co-circom CLI parties started at once on a card with no kernel
build: the first to need a kernel builds all of them under the build lock
(`_build.build`), the others wait for it.

    python3 scripts/torch_cli_cold_start.py

The package is copied into a temporary directory, so its `build/kernels/`
starts empty and the checkout's own build stays. In that copy it runs
split-input, then three `generate-witness --protocol REP3` processes over
plaintext TCP on a squaring chain of 2^13 - 2 constraints (its 8190 shares
a party reach K1 in `to_shared_witness_file`, so the first launch builds).
Prints one JSON line: each process's seconds and phase timings, the bytes
a peer, and the seconds after the parties' start at which the lock and
each library appeared. Needs one CUDA card and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTRAINTS = (1 << 13) - 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_cli_cold_start: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cosnarks_tpu_torch.groth16 import setup
    from torch_cli_procs import party_configs, run_cli

    with tempfile.TemporaryDirectory() as tree, \
            tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(ROOT, "cosnarks_tpu_torch"),
                        os.path.join(tree, "cosnarks_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        circuit = os.path.join(tmp, "chain.circom")
        with open(circuit, "w") as fh:
            fh.write(setup.chain_circom(CONSTRAINTS))
        with open(os.path.join(tmp, "input.json"), "w") as fh:
            json.dump({"x": "3"}, fh)
        run_cli([["split-input", "--input", os.path.join(tmp, "input.json"),
                  "--out-dir", tmp]], tmp, "split", cwd=tree)
        cfg = party_configs(tmp, "tcp", None)
        t0 = time.time()
        res = run_cli([["generate-witness", "--protocol", "REP3",
                        "--circuit", circuit, "--input",
                        os.path.join(tmp, f"input.json.{i}.shared"),
                        "--config", cfg[i], "--out",
                        os.path.join(tmp, f"witness.{i}.shared")]
                       for i in range(3)], tmp, "generate-witness", cwd=tree)
        kernels = os.path.join(tree, "build", "kernels")
        appeared = {}
        for d in os.listdir(kernels):
            for f in sorted(os.listdir(os.path.join(kernels, d))):
                if f == "lock" or f.endswith(".so"):
                    appeared[f] = os.path.getmtime(
                        os.path.join(kernels, d, f)) - t0
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "constraints": CONSTRAINTS,
        "process_s": [r["seconds"] for r in res],
        "phases_ms_by_party": [r["phases_ms"] for r in res],
        "net_bytes_by_party": [r["net_bytes_by_peer"] for r in res],
        "build_files_appeared_s": appeared}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
