"""Whole runs of every cell on the CPU at a tiny size, past the harness's
look for a card: a sound run comes out correct, and a run with the timed
path broken underneath (`portbench/faults.py`: the control, and each fault
the cell can have) comes out not correct.

The tiny sizes: proofs at domain 2^4, the share MSM at 2^7 points over two
scalar sets. A broken run skips the warm-up, except under `stale`, whose
prover hands back the warm-up's proof. The proof cases take minutes each on
the CPU; run them with several workers (`-n`)."""

import json
import shutil
import time

import pytest
import torch

from portbench import faults, run

SEED = 2 ** 31 + 11
TINY_CONFIG = {"groth16_bn254_rep3": {"domain_pow": 4},
               "plonk_bn254_rep3": {"domain_pow": 4}}
TINY_MIX = {"share_msm_2p20": {"points_log2": 7, "scalar_sets": 2}}
# The Groth16 proof job has no cell yet (PERF.md, Open questions): the tiny
# copy gives it one, so that the job stays held to its faults.
EXTRA_CELLS = [{"name": "groth16_bn254_rep3.prove", "config":
                "groth16_bn254_rep3", "traffic": "prove", "chips": 1,
                "why": "whole 3-party Rep3 Groth16 proofs"}]
CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"] + EXTRA_CELLS]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] += EXTRA_CELLS
    for m in bench["end_to_end"]:
        if m["name"] == "prove_s":
            m["workloads"] += [c["name"] for c in EXTRA_CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(run.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for folder, edits in (("configs", TINY_CONFIG), ("mixes", TINY_MIX)):
        for name, change in edits.items():
            path = root / "portbench" / folder / f"{name}.json"
            path.write_text(json.dumps({**json.loads(path.read_text()),
                                        **change}))
    return root


def _cases():
    for cell in CELLS:
        yield cell, None
        mix = "share_msm" if "share_msm" in cell else "prove"
        for fault in (faults.PROOF_FAULTS if mix == "prove"
                      else faults.MSM_FAULTS):
            yield cell, fault


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_tiny_run(tiny_root, cell, fault):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        c = run.load_cell(cell, tiny_root)
        assert fault is None or fault in faults.applicable(c)
        if fault not in (None, "stale"):
            c.mix["warmup_jobs"] = 0
        res = run.run_cell(c, SEED, 0.0, False, torch.device("cpu"),
                           time.perf_counter(), fault=fault)
    finally:
        torch.set_num_threads(threads)
    assert res.attempted == 1
    assert res.correct is (fault is None), res.line()
    assert set(res.metrics) >= {"setup_s"}
