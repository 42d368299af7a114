"""cosnarks_tpu_torch's PLONK against cosnarks_tpu's, on the CPU, over BN254
at domain 16 with three snarkjs additions (scripts/torch_plonk_fixture.py):
the plain and 3-party Rep3 proofs are byte-identical dicts given the same
zkey bytes, witness, share RNG and PRF seeds, all parties agree, both
packages' verifiers accept them and reject tampered ones, and a witness
that breaks a gate or a copy constraint gives a proof that does not
verify. The Rep3 shares go through the .shared files as co-circom feeds a
prover. Also Keccak-256 and the prover's doubling scan.

The JAX reference runs in a child process started once the zkey exists,
so its compile time (about two minutes) overlaps the port's proofs."""

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
from cosnarks_tpu.plonk import verify as jverify
from cosnarks_tpu.utils.keccak import keccak256 as jkeccak256
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.io import shared
from cosnarks_tpu_torch.io.zkey import parse_plonk_zkey
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.plonk import drivers, prove, verify
from cosnarks_tpu_torch.utils.keccak import keccak256

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_plonk_fixture import plonk_fixture  # noqa: E402

FIXTURE = (4, "bn254", 3, b"torch-plonk-test")
PLAIN_SEED = 7
SHARE_SEED = 5
SEEDS = [bytes([i + 1]) * 32 for i in range(3)]

# The child runs at the test workers' priority on one XLA thread: one core,
# like each worker. Below their priority, a loaded run starved its
# two-minute compile for up to fifteen minutes while this worker waited.
_CHILD_XLA = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")

# The same proofs through cosnarks_tpu: argv = zkey, witness json, out dir
_JAX_REFERENCE = f"""
import json, os, random, sys
import jax
jax.config.update("jax_platforms", "cpu")
from cosnarks_tpu.ff import mont
from cosnarks_tpu.io import shared
from cosnarks_tpu.io.zkey import parse_plonk_zkey
from cosnarks_tpu.mpc import rep3
from cosnarks_tpu.mpc.net.local import run_parties
from cosnarks_tpu.plonk import drivers, prove

zk = parse_plonk_zkey(open(sys.argv[1], "rb").read())
w = [int(v) for v in json.load(open(sys.argv[2]))]
ni = zk.n_public + 1
plain = prove.prove(zk, drivers.PlainPlonkDriver(zk.fr, seed={PLAIN_SEED}),
                    w[:ni], mont.encode(zk.fr, w[ni:]))
files = shared.split_witness_rep3(zk.fr, w, ni, random.Random({SHARE_SEED}))
seeds = {SEEDS!r}

def party(net):
    f = shared.read_shared_witness(files[net.id])
    state = rep3.Rep3State.setup(net, seeds[net.id])
    return prove.prove(zk, drivers.Rep3PlonkDriver(zk.fr, net, state),
                       f.public_inputs, rep3.Share(f.share_a, f.share_b))

proofs = run_parties([party] * 3)
with open(os.path.join(sys.argv[3], "proofs.json"), "w") as f:
    json.dump({{"plain": plain, "rep3": proofs}}, f)
"""


@pytest.fixture(scope="module")
def cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def circuit(cpu, tmp_path_factory):
    """(zkey bytes, vk, witness, a function returning the JAX proofs)."""
    data, vk, w = plonk_fixture(*FIXTURE, device="cpu")
    out = tmp_path_factory.mktemp("jax_plonk")
    (out / "zkey").write_bytes(data)
    (out / "w.json").write_text(json.dumps([str(v) for v in w]))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_REFERENCE, str(out / "zkey"),
         str(out / "w.json"), str(out)], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=_CHILD_XLA),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result = {}

    def jax_proofs():
        if not result:
            log, _ = proc.communicate(timeout=900)
            assert proc.returncode == 0, log[-4000:]
            result.update(json.loads((out / "proofs.json").read_text()))
        return result

    yield data, vk, w, jax_proofs
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _plain(data, w):
    zk = parse_plonk_zkey(data)
    ni = zk.n_public + 1
    return prove.prove(zk, drivers.PlainPlonkDriver(zk.fr, seed=PLAIN_SEED),
                       w[:ni], mont.encode(zk.fr, w[ni:]))


@pytest.fixture(scope="module")
def plain_proof(circuit):
    data, _, w, _ = circuit
    return _plain(data, w)


@pytest.fixture(scope="module")
def rep3_proofs(circuit):
    data, _, w, _ = circuit
    zk = parse_plonk_zkey(data)
    ni = zk.n_public + 1
    files = shared.split_witness_rep3(zk.fr, w, ni, random.Random(SHARE_SEED))

    def party(net):
        f = shared.read_shared_witness(files[net.id])
        state = rep3.Rep3State.setup(net, SEEDS[net.id])
        return prove.prove(zk, drivers.Rep3PlonkDriver(zk.fr, net, state),
                           f.public_inputs, rep3.Share(f.share_a, f.share_b))

    return run_parties([party] * 3)


def _publics(w):
    return w[1:3]


def test_tampered_proof_and_publics_are_rejected(circuit, plain_proof):
    _, vk, w, _ = circuit
    bad = dict(plain_proof, eval_a=str(int(plain_proof["eval_a"]) + 1))
    assert not verify.verify(vk, bad, _publics(w))
    assert not jverify.verify(vk, bad, _publics(w))
    wrong = [w[1], (w[2] + 1) % BN254_FR.p]
    assert not verify.verify(vk, plain_proof, wrong)
    assert not verify.verify(vk, plain_proof, w[1:2])


def test_broken_gate_is_rejected(circuit):
    """x_1 off by one: the chain gates x_0^2 = x_1 and x_1^2 = x_2 fail."""
    data, vk, w, _ = circuit
    broken = list(w)
    broken[3] = (broken[3] + 1) % BN254_FR.p
    proof = _plain(data, broken)
    assert not verify.verify(vk, proof, _publics(w))
    assert not jverify.verify(vk, proof, _publics(w))


def test_broken_copy_constraint_is_rejected(circuit):
    """One chain gate rewired to the next squaring: the gate holds but its
    a, b and c slots leave their signals' copy cycles."""
    data, vk, w, _ = circuit
    zk = parse_plonk_zkey(data)
    g = 3  # chain gate x_1^2 = x_2 (signals 3 and 4); rewire to x_2^2 = x_3
    assert (zk.map_a[g], zk.map_b[g], zk.map_c[g]) == (3, 3, 4)
    zk.map_a[g] = zk.map_b[g] = 4
    zk.map_c[g] = 5
    assert w[4] * w[4] % BN254_FR.p == w[5]
    ni = zk.n_public + 1
    proof = prove.prove(zk, drivers.PlainPlonkDriver(zk.fr, seed=PLAIN_SEED),
                        w[:ni], mont.encode(zk.fr, w[ni:]))
    assert not verify.verify(vk, proof, _publics(w))


@pytest.mark.parametrize("size", [0, 3, 135, 136, 137, 300])
def test_keccak_matches_jax(size):
    data = bytes((7 * i + 3) % 256 for i in range(size))
    assert keccak256(data) == jkeccak256(data)
    if size == 0:
        assert keccak256(b"").hex() == (
            "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


@pytest.mark.parametrize("k", [1, 2, 13, 32])
def test_doubling_scan_matches_serial(cpu, k):
    field = BN254_FR
    rng = random.Random(k)
    vals = [rng.randrange(field.p) for _ in range(k)]
    x = mont.encode(field, vals)
    prods = mont.decode(field, prove._cumprod_mont(field, x))
    sums = mont.decode(field, prove.scan(
        lambda u, v: mont.add(field, u, v), x, reverse=True))
    acc, want_prods = 1, []
    for v in vals:
        acc = acc * v % field.p
        want_prods.append(acc)
    want_sums = [sum(vals[i:]) % field.p for i in range(k)]
    assert prods == want_prods
    assert sums == want_sums
    # the serial scan through the same device ops gives the same limbs
    serial = [x[0]]
    for i in range(1, k):
        serial.append(mont.mul(field, serial[-1], x[i]))
    assert np.array_equal(torch.stack(serial).numpy(),
                          prove._cumprod_mont(field, x).numpy())


# The comparisons with the JAX child come last, so that the port's proofs
# above run while the child compiles.
def test_rep3_proof_matches_jax_and_verifies(circuit, rep3_proofs):
    _, vk, w, jax_proofs = circuit
    assert rep3_proofs[0] == rep3_proofs[1] == rep3_proofs[2]
    assert rep3_proofs == jax_proofs()["rep3"]
    assert verify.verify(vk, rep3_proofs[0], _publics(w))
    assert jverify.verify(vk, rep3_proofs[0], _publics(w))


def test_plain_proof_matches_jax_and_verifies(circuit, plain_proof):
    _, vk, w, jax_proofs = circuit
    assert plain_proof == jax_proofs()["plain"]
    assert verify.verify(vk, plain_proof, _publics(w))
    assert jverify.verify(vk, plain_proof, _publics(w))
