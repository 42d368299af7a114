"""coNoir's co-UltraHonk cell (`ultrahonk_bn254_rep3.coproof_2p16`) on the
CPU at a tiny size: the plain reference (`reference/ultrahonk.py`) against
the port's plain Keccak UltraHonk proof, the cell's files found by name,
and whole runs of the cell whose check comes out correct, and not correct
with one party's share of `w_l` changed in one element.

The tiny size: the synthetic Noir program at 128 rows (no RANGE and no
AND / XOR, whose lookup tables alone take 2^14 rows), a CRS on the host.
A co-proof takes about half a minute on one CPU thread, so each run has one
proof in its window and no warm-up."""

import json
import shutil
import time

import pytest
import torch

from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.honk import builder, co_prover, crs as honk_crs
from cosnarks_tpu_torch.honk import prover, proving_key as hpk
from cosnarks_tpu_torch.honk.transcript import HASHERS
from cosnarks_tpu_torch.mpc.rep3_scalar import AShare
from cosnarks_tpu_torch.noir import acir, solver, synthetic
from cosnarks_tpu_torch.vm.interp import PlainDriver

from portbench import run
from portbench.reference import ultrahonk as ref
from portbench.reference.bn254 import R

SEED = 2 ** 31 + 29
CELL = "ultrahonk_bn254_rep3.coproof_2p16"
TINY_PROGRAM = dict(n_inputs=4, n_square=1, n_linear=1, n_big=1, n_range=0,
                    n_logic=0, n_poseidon=1, n_reads=1)  # 128 rows
TINY_LOG_ROWS = 7
TAU = 0x5EED_7A0
READERS = ("sumcheck_s.coproof", "honk_syncs.coproof", "mpc_bytes.coproof")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def plain(one_thread, tmp_path_factory):
    """The port's plain Keccak UltraHonk proof of the tiny program on a
    host CRS: (proving key, verifying key, CRS, proof, public inputs)."""
    path = tmp_path_factory.mktemp("noir") / "program.json"
    acir.dump_artifact(path, *synthetic.synthetic_program(**TINY_PROGRAM))
    art = acir.load_artifact(path)
    af = builder.AcirFormat.from_function(art.functions[0])
    wmap = solver.solve_program(art, PlainDriver(BN254_FR), R,
                                synthetic.synthetic_inputs(4, 7))
    wit = [int(wmap.get(i, 0)) for i in range(af.max_witness_index + 1)]
    pk = hpk.create_proving_key(builder.UltraBuilder.create_circuit(af, wit))
    assert pk.circuit_size == 1 << TINY_LOG_ROWS
    crs = honk_crs.local_crs(pk.circuit_size, tau=TAU)
    pkd = pk.to_device("cpu")
    vk = hpk.create_vk(pkd, crs)
    proof, public = prover.prove(pkd, vk, crs, HASHERS["keccak"])
    return pk, vk, crs, proof, public


def _ref_vk(pk, vk):
    return ref.VerifyingKey(
        vk.log_circuit_size, vk.num_public_inputs, vk.pub_inputs_offset,
        [ref.commitment([int(v) for v in pk.polynomials[name]], TAU)
         for name in ref.PRECOMPUTED])


def test_reference_commitments_are_create_vks(plain):
    pk, vk, crs, _, _ = plain
    assert _ref_vk(pk, vk).commitments == vk.commitments
    assert ref.g2_x(TAU) == crs.g2_x
    assert [ref.crs_point(i, TAU) for i in (0, 1, 77)] == \
        [crs.monomials[i] for i in (0, 1, 77)]


def test_reference_accepts_the_ports_plain_proof(plain):
    pk, vk, _, proof, public = plain
    assert len(public) == 1
    assert ref.verify(_ref_vk(pk, vk), proof, public, ref.g2_x(TAU))


@pytest.mark.parametrize("change", ["word", "public_input", "extra_word"])
def test_reference_refuses(plain, change):
    pk, vk, _, proof, public = plain
    proof, public = list(proof), list(public)
    if change == "word":
        proof[len(proof) // 2] = (proof[len(proof) // 2] + 1) % R
    elif change == "public_input":
        public[0] = (public[0] + 1) % R
    else:
        proof.append(0)
    assert not ref.verify(_ref_vk(pk, vk), proof, public, ref.g2_x(TAU))


def test_the_cell_finds_its_files():
    c = run.load_cell(CELL)
    assert c.config["protocol"] == "ultrahonk" and c.config["log_rows"] == 16
    assert c.config["program"] == synthetic.SMOKE_PROGRAM
    assert c.mix["job"] == "coproof" and c.mix["input_sets"] == 2
    assert c.job_path.name == "ultrahonk_coproof.py"
    assert {m["name"] for m, _ in c.per_layer} == set(READERS)
    assert {m["name"] for m, _ in c.end_to_end} == {"setup_s", "prove_s"}
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    mine = next(e for e in bench["configs"] if e["name"] == c.config["name"])
    assert mine["source"] == c.config["source"]
    assert all(e["source"] != mine["source"] for e in bench["configs"]
               if e is not mine)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    shutil.copy(run.ROOT / "BENCHMARK.json", root)
    shutil.copytree(run.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "portbench" / "configs" / "ultrahonk_bn254_rep3.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "program": TINY_PROGRAM,
                                "log_rows": TINY_LOG_ROWS}))
    return root


def _run(root, trace):
    c = run.load_cell(CELL, root)
    c.mix["warmup_jobs"] = 0
    return run.run_cell(c, SEED, 0.0, trace, torch.device("cpu"),
                        time.perf_counter())


def test_a_traced_tiny_run_is_correct_and_read(one_thread, tiny_root):
    res = _run(tiny_root, True)
    assert res.correct and res.attempted == 1, res.line()
    assert {n: v for n, v, _ in res.checks} == {"failed_proofs": 0,
                                                 "key_mismatches": 0}
    for name in READERS:
        assert res.metrics[name]["value"] > 0, name


def test_a_changed_share_fails_the_check(one_thread, tiny_root,
                                         monkeypatch):
    """Party 0's share of w_l changed in one element, at the first row an
    arithmetic gate uses."""
    orig = co_prover.share_proving_key

    def share_proving_key(pk, rng=None):
        shares = orig(pk, rng)
        row = next(i for i, q in enumerate(pk.polynomials["q_arith"]) if q)
        a = shares[0]["w_l"][row]
        shares[0]["w_l"][row] = AShare((a.a + 1) % R, a.b)
        return shares

    monkeypatch.setattr(co_prover, "share_proving_key", share_proving_key)
    res = _run(tiny_root, False)
    assert not res.correct and res.attempted == 1
    assert {n: v for n, v, _ in res.checks} == {"failed_proofs": 1,
                                                 "key_mismatches": 0}
