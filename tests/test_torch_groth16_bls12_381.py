"""cosnarks_tpu_torch Groth16 over BLS12-381 against cosnarks_tpu at a
BLS12-381 synthetic_zkey(30) (domain 32), on the CPU: the plain-driver
proof and the 3-party Rep3 proof are byte-identical to the JAX package's,
given the same share RNG and PRF seeds, and verify under both packages'
verifiers.

The port's zkey is the input of both packages: a JAX reference child
process builds its Groth16Zkey from the port's arrays with
BLS12_381_FQ/FR (the JAX package's synthetic setup is BN254 only) and
proves while the port proves."""

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
from cosnarks_tpu.groth16 import verify as jverify
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff import spec as tspec
from cosnarks_tpu_torch.groth16 import drivers, prove, setup
from cosnarks_tpu_torch.groth16 import verify as tverify
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties

ROOT = Path(__file__).resolve().parent.parent
N_CONSTRAINTS = 30
PLAIN_SEED = 7
SHARE_SEED = 5
SEEDS = [bytes([i + 1]) * 32 for i in range(3)]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


# The child runs on one XLA thread, one core like each test worker: the
# suite runs several such children beside its workers.
_CHILD_XLA = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")

# The JAX package's plain and Rep3 proofs on the port's zkey arrays
# (argv[1]/zkey.npz, meta.json), written to argv[1]/proofs.json.
_JAX_REFERENCE = f"""
import json, os, random, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from cosnarks_tpu.ff import mont
from cosnarks_tpu.ff.spec import BLS12_381_FQ, BLS12_381_FR
from cosnarks_tpu.groth16 import drivers, prove
from cosnarks_tpu.io.zkey import Groth16Zkey
from cosnarks_tpu.mpc import rep3
from cosnarks_tpu.mpc.net.local import run_parties

out = sys.argv[1]
with open(os.path.join(out, "meta.json")) as f:
    meta = json.load(f)
zkey = Groth16Zkey(fq=BLS12_381_FQ, fr=BLS12_381_FR, n_vars=meta["n_vars"],
                   n_public=meta["n_public"],
                   domain_size=meta["domain_size"],
                   **dict(np.load(os.path.join(out, "zkey.npz"))))
w = [int(x) for x in meta["w"]]
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
def groth16(tmp_path_factory, _cpu):
    """The port's zkey, then the JAX reference child on its arrays while
    the port proves (plain and 3-party Rep3); returns the port's results
    and a function that waits for the reference's proofs."""
    out = tmp_path_factory.mktemp("bls12_381_reference")
    zkey, w = setup.synthetic_zkey(N_CONSTRAINTS,
                                   curve_pair=setup.BLS12_381)
    np.savez(out / "zkey.npz",
             **{k: v for k, v in vars(zkey).items()
                if isinstance(v, np.ndarray)})
    (out / "meta.json").write_text(json.dumps(
        {"n_vars": zkey.n_vars, "n_public": zkey.n_public,
         "domain_size": zkey.domain_size, "w": [str(x) for x in w]}))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=_CHILD_XLA)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_REFERENCE, str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
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
        result = {}

        def reference():
            if not result:
                log, _ = proc.communicate(timeout=900)
                assert proc.returncode == 0, log[-4000:]
                result.update(json.loads(
                    (out / "proofs.json").read_text()))
            return result

        yield {"zkey": zkey, "w": w, "plain": plain, "rep3": proofs,
               "reference": reference}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _as_json(proof):
    return json.loads(json.dumps(proof))


def _verifies(zkey, proof, public):
    """The proof under both packages' verifiers (curve-dispatching and
    BLS12-381)."""
    vk = prove.vk_from_zkey(zkey)
    return (tverify.verify(vk, proof, public)
            and tverify.verify_bls12_381(vk, proof, public)
            and jverify.verify(vk, proof, public)
            and jverify.verify_bls12_381(vk, proof, public))


def test_synthetic_zkey_is_bls12_381(groth16):
    zkey = groth16["zkey"]
    assert zkey.fq == tspec.BLS12_381_FQ and zkey.fr == tspec.BLS12_381_FR
    assert zkey.domain_size == 32
    assert zkey.a_query.shape[1:] == (2, 24)
    assert zkey.b_g2_query.shape[1:] == (2, 2, 24)
    assert zkey.coeff_val.shape[1:] == (16,)
    vk = prove.vk_from_zkey(zkey)
    assert vk["curve"] == "bls12381"
    w = groth16["w"]
    assert not tverify.verify(vk, groth16["plain"], [w[1] + 1])


def test_plain_proof_matches_jax_and_verifies(groth16):
    ref = groth16["reference"]()
    assert _as_json(groth16["plain"]) == ref["plain"]
    zkey, w = groth16["zkey"], groth16["w"]
    assert _verifies(zkey, groth16["plain"], w[1:zkey.n_public + 1])


def test_rep3_proof_matches_jax_and_verifies(groth16):
    got = [_as_json(p) for p in groth16["rep3"]]
    assert got[0] == got[1] == got[2]
    zkey, w = groth16["zkey"], groth16["w"]
    assert _verifies(zkey, groth16["rep3"][0], w[1:zkey.n_public + 1])
    assert got == groth16["reference"]()["rep3"]
