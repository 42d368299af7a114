"""cosnarks_tpu_torch's plain PLONK over BLS12-381 against cosnarks_tpu's,
on the CPU, at domain 8 with one snarkjs addition
(scripts/torch_plonk_fixture.py): the transcript writes 48-byte Fq
coordinates, Fr runs at 16 limbs and G1 at 24, and the proof is
byte-identical to the JAX package's and verifies in both packages.

The JAX reference runs in a child process started once the zkey exists."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.plonk import verify as jverify
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.io.zkey import parse_plonk_zkey
from cosnarks_tpu_torch.plonk import drivers, prove, verify

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_plonk_fixture import plonk_fixture  # noqa: E402

FIXTURE = (3, "bls12_381", 1, b"torch-plonk-bls")
PLAIN_SEED = 11

# The child runs at the test workers' priority on one XLA thread: one core,
# like each worker. Below their priority, a loaded run starved its
# two-minute compile for up to fifteen minutes while this worker waited.
_CHILD_XLA = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")

_JAX_REFERENCE = f"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from cosnarks_tpu.ff import mont
from cosnarks_tpu.io.zkey import parse_plonk_zkey
from cosnarks_tpu.plonk import drivers, prove

zk = parse_plonk_zkey(open(sys.argv[1], "rb").read())
w = [int(v) for v in json.load(open(sys.argv[2]))]
ni = zk.n_public + 1
proof = prove.prove(zk, drivers.PlainPlonkDriver(zk.fr, seed={PLAIN_SEED}),
                    w[:ni], mont.encode(zk.fr, w[ni:]))
with open(sys.argv[3], "w") as f:
    json.dump(proof, f)
"""


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """(zkey, vk, witness, the port's proof, the JAX package's proof)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    proc = None
    try:
        data, vk, w = plonk_fixture(*FIXTURE, device="cpu")
        out = tmp_path_factory.mktemp("jax_plonk_bls")
        (out / "zkey").write_bytes(data)
        (out / "w.json").write_text(json.dumps([str(v) for v in w]))
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_REFERENCE, str(out / "zkey"),
             str(out / "w.json"), str(out / "proof.json")], cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=_CHILD_XLA),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        zk = parse_plonk_zkey(data)
        ni = zk.n_public + 1
        got = prove.prove(zk, drivers.PlainPlonkDriver(zk.fr, seed=PLAIN_SEED),
                          w[:ni], mont.encode(zk.fr, w[ni:]))
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log[-4000:]
        yield zk, vk, w, got, json.loads((out / "proof.json").read_text())
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        ct.set_default_device(None)
        torch.set_num_threads(threads)


def test_bls12_381_zkey_widths(proofs):
    zk, vk, _, _, _ = proofs
    assert (zk.fq.nlimbs, zk.fr.nlimbs, zk.domain_size) == (24, 16, 8)
    assert zk.p_tau.shape == (8 + 6, 2, 24) and vk["curve"] == "bls12381"


def test_bls12_381_plain_proof_matches_jax(proofs):
    _, _, _, got, ref = proofs
    assert got == ref
    assert got["curve"] == "bls12381"


def test_bls12_381_plain_proof_verifies_in_both_packages(proofs):
    _, vk, w, got, _ = proofs
    assert verify.verify(vk, got, w[1:3])
    assert jverify.verify(vk, got, w[1:3])
    bad = dict(got, eval_b=str(int(got["eval_b"]) + 1))
    assert not verify.verify(vk, bad, w[1:3])
