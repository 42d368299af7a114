"""The port's collaborative UltraHonk prover against the JAX package's
plain one, on the CPU: a synthetic Noir program (AssertZero, Poseidon2,
ROM) with Rep3-shared inputs runs the port's 3-party co-ACVM
(noir.solver over vm.rep3_driver), the MPC UltraCircuitBuilder
(create_circuit(driver=...)), create_proving_key and split_builder_pk,
then co_prove (Keccak) on device shares; every party's proof equals,
word for word, the JAX package's plain proof of the same program, and
both verifiers accept it. The opened witness equals the plain one.
"""

import random

import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.honk import builder as jbuilder
from cosnarks_tpu.honk import crs as jcrs
from cosnarks_tpu.honk import prover as jprover
from cosnarks_tpu.honk import proving_key as jpk
from cosnarks_tpu.honk import transcript as jtranscript
from cosnarks_tpu.honk import verifier as jverifier
from cosnarks_tpu.noir import acir as jacir
from cosnarks_tpu.noir import solver as jsolver
from cosnarks_tpu.ff.spec import BN254_FR as JFR
from cosnarks_tpu.vm import interp as jinterp
from cosnarks_tpu_torch import convert
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.honk import builder, co_prover
from cosnarks_tpu_torch.honk import proving_key as hpk
from cosnarks_tpu_torch.honk import transcript, verifier
from cosnarks_tpu_torch.honk.co_driver import Rep3HonkDriver
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.mpc.rep3_scalar import AShare, HostRng, Rep3Scalar
from cosnarks_tpu_torch.noir import acir, solver, synthetic
from cosnarks_tpu_torch.vm.rep3_driver import Rep3Driver

R = BN254_FR.p
PROGRAM = dict(n_inputs=4, n_square=1, n_linear=1, n_big=1, n_range=0,
               n_logic=0, n_poseidon=1, n_reads=1)  # 128 rows


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def test_rep3_co_proof_equals_jax_plain_proof(tmp_path):
    path = str(tmp_path / "prog.json")
    acir.dump_artifact(path, *synthetic.synthetic_program(**PROGRAM))
    inputs = synthetic.synthetic_inputs(PROGRAM["n_inputs"], 33)

    # the JAX package's plain pipeline: witness, key, CRS, proof
    jart = jacir.load_artifact(path)
    jaf = jbuilder.AcirFormat.from_function(jart.functions[0])
    jw = jsolver.solve_program(jart, jinterp.PlainDriver(JFR), R, inputs)
    plain_wit = [int(jw.get(i, 0)) for i in range(jaf.max_witness_index + 1)]
    jk = jpk.create_proving_key(
        jbuilder.UltraBuilder.create_circuit(jaf, plain_wit))
    assert jk.circuit_size == 128
    jc = jcrs.local_crs(jk.circuit_size)
    jvk = jpk.create_vk(jk, jc)
    expect = jprover.prove(jk, jvk, jc, jtranscript.HASHERS["keccak"])

    art = acir.load_artifact(path)
    af = builder.AcirFormat.from_function(art.functions[0])
    crs = convert.honk_crs_from_numpy(jc)
    rand = random.Random(9).randbytes
    shares = [Rep3Scalar.share(v, R, rand=rand) for v in inputs]
    H = transcript.HASHERS["keccak"]

    def party(net):
        k = net.id
        keys = [bytes([51 + j]) * 32 for j in range(3)]
        rng = HostRng(keys[k], keys[(k + 1) % 3])
        vm = Rep3Driver(Rep3Scalar(net, rng, R), BN254_FR)
        wmap = solver.solve_program(art, vm, R, [s[k] for s in shares])
        wit = [vm.norm(wmap.get(i, 0))
               for i in range(af.max_witness_index + 1)]
        opened = [vm.open(v) if vm.is_shared(v) else int(v) for v in wit]
        b = builder.UltraBuilder.create_circuit(af, wit, driver=vm)
        pk = hpk.create_proving_key(b)
        vk = hpk.create_vk(pk, crs)
        drv = Rep3HonkDriver(net, rep3.Rep3State.setup(
            net, bytes([k + 71]) * 32, device="cpu"))
        pk_pub, shared = co_prover.split_builder_pk(pk, drv)
        assert all(isinstance(v, AShare) for v in shared["w_l"])
        proof = co_prover.co_prove(pk_pub, shared, vk, crs, H, drv)
        return [int(v) for v in opened], vk, proof, drv.rounds

    res = run_parties([party] * 3)
    assert res[0][0] == plain_wit
    assert res[0][1].commitments == jvk.commitments
    assert res[0][2] == res[1][2] == res[2][2]
    assert res[0][2] == expect
    assert res[0][3] > 0
    proof, pub = res[0][2]
    assert verifier.verify(proof, pub, res[0][1], crs.g2_x, H)
    assert jverifier.verify(proof, pub, jvk, jc.g2_x,
                            jtranscript.HASHERS["keccak"])
