"""cosnarks_tpu_torch 3-party Shamir (n = 3, t = 1) Groth16 against
cosnarks_tpu at synthetic_zkey(30) (domain 32), on the CPU: given the same
share RNG and ShamirState seeds the proof dicts are equal, all parties agree,
and the proof verifies.

The JAX reference runs in a child process started when the module's first
test needs it, so its compile time overlaps the port's run."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu_torch.groth16 import drivers, prove, setup
from cosnarks_tpu_torch.groth16.verify import verify_bn254
from cosnarks_tpu_torch.mpc import shamir
from cosnarks_tpu_torch.mpc.net.local import run_parties

ROOT = Path(__file__).resolve().parent.parent
N_CONSTRAINTS = 30
SHARE_SEED = 5
SEEDS = [bytes([i + 1]) * 32 for i in range(3)]

# The child runs on one XLA thread, one core like each test worker: the
# suite runs several such children beside its workers.
_CHILD_XLA = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")

# The same proof through cosnarks_tpu, written to argv[1] as JSON.
_JAX_REFERENCE = f"""
import json, random, sys
import jax
jax.config.update("jax_platforms", "cpu")
from cosnarks_tpu.groth16 import drivers, prove, setup
from cosnarks_tpu.mpc import shamir
from cosnarks_tpu.mpc.net.local import run_parties

zkey, w = setup.synthetic_zkey({N_CONSTRAINTS})
ni = zkey.n_public + 1
shares = shamir.share_values(zkey.fr, w[ni:], 3, 1, random.Random({SHARE_SEED}))
seeds = {SEEDS!r}

def party(net):
    st = shamir.ShamirState.setup(net, zkey.fr, 1, pairs=32, seed=seeds[net.id])
    return prove.prove(drivers.ShamirDriver(net, st), zkey,
                       prove.SharedWitness(w[:ni], shares[net.id]))

with open(sys.argv[1], "w") as f:
    json.dump(run_parties([party] * 3), f)
"""


@pytest.fixture(scope="module")
def jax_proofs(tmp_path_factory):
    """Starts the reference child process; yields a function that waits for
    it and returns the three parties' proofs."""
    out = tmp_path_factory.mktemp("jax_shamir") / "proofs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=_CHILD_XLA)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_REFERENCE, str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result = []

    def wait():
        if not result:
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log[-4000:]
            result.append(json.loads(out.read_text()))
        return result[0]

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port(jax_proofs):
    """zkey and the three parties' Shamir proofs through the port (while the
    reference runs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    try:
        zkey, w = setup.synthetic_zkey(N_CONSTRAINTS)
        ni = zkey.n_public + 1
        shares = shamir.share_values(zkey.fr, w[ni:], 3, 1,
                                     random.Random(SHARE_SEED))

        def party(net):
            st = shamir.ShamirState.setup(net, zkey.fr, 1, pairs=32,
                                          seed=SEEDS[net.id])
            return prove.prove(drivers.ShamirDriver(net, st), zkey,
                               prove.SharedWitness(w[:ni], shares[net.id]))

        yield {"zkey": zkey, "w": w, "proofs": run_parties([party] * 3)}
    finally:
        ct.set_default_device(None)
        torch.set_num_threads(threads)


def test_shamir_parties_agree_and_proof_verifies(port):
    proofs = port["proofs"]
    assert proofs[0] == proofs[1] == proofs[2]
    ni = port["zkey"].n_public + 1
    assert verify_bn254(prove.vk_from_zkey(port["zkey"]), proofs[0],
                        port["w"][1:ni])


def test_shamir_proof_matches_jax(port, jax_proofs):
    got = [json.loads(json.dumps(p)) for p in port["proofs"]]
    assert got == jax_proofs()
