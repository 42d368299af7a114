"""cosnarks_tpu_torch's 3-party Shamir (n = 3, t = 1) PLONK against
cosnarks_tpu's, on the CPU, at the BN254 domain-16 fixture of
test_torch_plonk.py: the shares go through .shared files, all parties
agree, the proof is byte-identical to the JAX package's given the same share
RNG and state seeds (the prover's forked states draw the same pairs), and
both packages' verifiers accept it.

The JAX reference runs in a child process started once the zkey exists."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.plonk import verify as jverify
from cosnarks_tpu_torch.io import shared
from cosnarks_tpu_torch.io.zkey import parse_plonk_zkey
from cosnarks_tpu_torch.mpc import shamir
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.plonk import drivers, prove, verify

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_plonk_fixture import plonk_fixture  # noqa: E402

FIXTURE = (4, "bn254", 3, b"torch-plonk-test")
SHARE_SEED = 6
PAIRS = 64
SEEDS = [bytes([i + 0x51]) * 32 for i in range(3)]

# The child runs at the test workers' priority on one XLA thread: one core,
# like each worker. Below their priority, a loaded run starved its
# two-minute compile for up to fifteen minutes while this worker waited.
_CHILD_XLA = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")

_JAX_REFERENCE = f"""
import json, os, random, sys
import jax
jax.config.update("jax_platforms", "cpu")
from cosnarks_tpu.io import shared
from cosnarks_tpu.io.zkey import parse_plonk_zkey
from cosnarks_tpu.mpc import shamir
from cosnarks_tpu.mpc.net.local import run_parties
from cosnarks_tpu.plonk import drivers, prove

zk = parse_plonk_zkey(open(sys.argv[1], "rb").read())
w = [int(v) for v in json.load(open(sys.argv[2]))]
ni = zk.n_public + 1
files = shared.split_witness_shamir(zk.fr, w, ni, 3, 1,
                                    random.Random({SHARE_SEED}))
seeds = {SEEDS!r}

def party(net):
    f = shared.read_shared_witness(files[net.id])
    state = shamir.ShamirState.setup(net, zk.fr, 1, pairs={PAIRS},
                                     seed=seeds[net.id])
    return prove.prove(zk, drivers.ShamirPlonkDriver(zk.fr, net, state),
                       f.public_inputs, f.share_a)

proofs = run_parties([party] * 3)
with open(os.path.join(sys.argv[3], "proofs.json"), "w") as f:
    json.dump(proofs, f)
"""


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    """(vk, witness, the port's proofs, the JAX package's proofs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    proc = None
    try:
        data, vk, w = plonk_fixture(*FIXTURE, device="cpu")
        out = tmp_path_factory.mktemp("jax_plonk_shamir")
        (out / "zkey").write_bytes(data)
        (out / "w.json").write_text(json.dumps([str(v) for v in w]))
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_REFERENCE, str(out / "zkey"),
             str(out / "w.json"), str(out)], cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=_CHILD_XLA),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        zk = parse_plonk_zkey(data)
        ni = zk.n_public + 1
        files = shared.split_witness_shamir(zk.fr, w, ni, 3, 1,
                                            random.Random(SHARE_SEED))

        def party(net):
            f = shared.read_shared_witness(files[net.id])
            state = shamir.ShamirState.setup(net, zk.fr, 1, pairs=PAIRS,
                                             seed=SEEDS[net.id])
            return prove.prove(zk, drivers.ShamirPlonkDriver(zk.fr, net,
                                                             state),
                               f.public_inputs, f.share_a)

        got = run_parties([party] * 3)
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log[-4000:]
        yield vk, w, got, json.loads((out / "proofs.json").read_text())
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        ct.set_default_device(None)
        torch.set_num_threads(threads)


def test_shamir_parties_agree(proofs):
    _, _, got, _ = proofs
    assert got[0] == got[1] == got[2]


def test_shamir_proof_matches_jax(proofs):
    _, _, got, ref = proofs
    assert got == ref


def test_shamir_proof_verifies_in_both_packages(proofs):
    vk, w, got, _ = proofs
    assert verify.verify(vk, got[0], w[1:3])
    assert jverify.verify(vk, got[0], w[1:3])
