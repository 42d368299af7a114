"""cosnarks_tpu_torch Groth16 against cosnarks_tpu at synthetic_zkey(30)
(domain 32), on the CPU: the zkey arrays, the plain-driver proof and the
3-party Rep3 proof are equal, given the same share RNG and PRF seeds, and
verify.

The JAX reference runs in a child process started when the module's first
test needs it, so its compile time overlaps the port's run."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.groth16 import drivers, prove, setup
from cosnarks_tpu_torch.groth16.verify import verify_bn254
from cosnarks_tpu_torch.io.zkey import Groth16Zkey
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties

ROOT = Path(__file__).resolve().parent.parent
N_CONSTRAINTS = 30
PLAIN_SEED = 7
SHARE_SEED = 5
SEEDS = [bytes([i + 1]) * 32 for i in range(3)]

# The child runs on one XLA thread, one core like each test worker: the
# suite runs several such children beside its workers.
_CHILD_XLA = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")

# The same steps through cosnarks_tpu, written to argv[1]: zkey arrays
# (zkey.npz) and both proofs (proofs.json).
_JAX_REFERENCE = f"""
import json, os, random, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from cosnarks_tpu.ff import mont
from cosnarks_tpu.groth16 import drivers, prove, setup
from cosnarks_tpu.mpc import rep3
from cosnarks_tpu.mpc.net.local import run_parties

out = sys.argv[1]
zkey, w = setup.synthetic_zkey({N_CONSTRAINTS})
np.savez(os.path.join(out, "zkey.npz"),
         **{{k: v for k, v in vars(zkey).items() if isinstance(v, np.ndarray)}})
ni = zkey.n_public + 1
plain = prove.prove(drivers.PlainDriver(seed={PLAIN_SEED}), zkey,
                    prove.SharedWitness(w[:ni], mont.encode(zkey.fr, w[ni:])))
shares = rep3.share_field_elements(zkey.fr, w[ni:],
                                   random.Random({SHARE_SEED}))
seeds = {SEEDS!r}

def party(net):
    state = rep3.Rep3State.setup(net, seeds[net.id])
    return prove.prove(drivers.Rep3Driver(net, state), zkey,
                       prove.SharedWitness(w[:ni], shares[net.id]))

proofs = run_parties([party] * 3)
with open(os.path.join(out, "proofs.json"), "w") as f:
    json.dump({{"plain": plain, "rep3": proofs}}, f)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """Starts the reference child process; yields a function that waits for
    it and returns (zkey arrays, proofs)."""
    out = tmp_path_factory.mktemp("jax_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=_CHILD_XLA)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_REFERENCE, str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result = {}

    def wait():
        if not result:
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log[-4000:]
            result["zkey"] = dict(np.load(out / "zkey.npz"))
            result["proofs"] = json.loads((out / "proofs.json").read_text())
        return result["zkey"], result["proofs"]

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port(jax_reference):
    """zkey, plain proof and Rep3 proofs through the port (while the
    reference runs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    try:
        zkey, w = setup.synthetic_zkey(N_CONSTRAINTS)
        ni = zkey.n_public + 1
        plain = prove.prove(
            drivers.PlainDriver(seed=PLAIN_SEED), zkey,
            prove.SharedWitness(w[:ni], mont.encode(zkey.fr, w[ni:])))
        shares = rep3.share_field_elements(zkey.fr, w[ni:],
                                           random.Random(SHARE_SEED))

        def party(net):
            state = rep3.Rep3State.setup(net, SEEDS[net.id])
            return prove.prove(drivers.Rep3Driver(net, state), zkey,
                               prove.SharedWitness(w[:ni], shares[net.id]))

        proofs = run_parties([party] * 3)
        yield {"zkey": zkey, "w": w, "plain": plain, "rep3": proofs}
    finally:
        ct.set_default_device(None)
        torch.set_num_threads(threads)


def _as_json(proof):
    return json.loads(json.dumps(proof))


def test_synthetic_zkey_matches_jax(port, jax_reference):
    ref, _ = jax_reference()
    zkey = port["zkey"]
    arrays = [k for k, f in Groth16Zkey.__dataclass_fields__.items()
              if isinstance(getattr(zkey, k), np.ndarray)]
    assert sorted(arrays) == sorted(ref)
    for k in arrays:
        assert np.array_equal(getattr(zkey, k), ref[k]), k
    assert zkey.domain_size == 32


def test_plain_proof_matches_jax_and_verifies(port, jax_reference):
    _, proofs = jax_reference()
    assert _as_json(port["plain"]) == proofs["plain"]
    w = port["w"]
    vk = prove.vk_from_zkey(port["zkey"])
    assert verify_bn254(vk, port["plain"], w[1:port["zkey"].n_public + 1])


def test_rep3_proof_matches_jax_and_verifies(port, jax_reference):
    _, proofs = jax_reference()
    got = [_as_json(p) for p in port["rep3"]]
    assert got[0] == got[1] == got[2]
    assert got == proofs["rep3"]
    w = port["w"]
    vk = prove.vk_from_zkey(port["zkey"])
    assert verify_bn254(vk, port["rep3"][0],
                        w[1:port["zkey"].n_public + 1])
