"""cosnarks_tpu_torch 3-party Rep3 Groth16 at synthetic_zkey(126) (domain
128), port only, on the CPU, from a witness of the port's circom VM: the
zkey's squaring chain, written as circom, runs through the Rep3 witness
extension into each party's .shared file, and each party proves from the
file it reads back. Every G1 query MSM takes the Pippenger path through
the K4 plain fold; all parties return one proof, and it verifies."""

import json
import random

import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu_torch.groth16 import drivers, prove, setup
from cosnarks_tpu_torch.groth16.verify import verify_bn254
from cosnarks_tpu_torch.io import shared
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.vm import lang, mpc_run

SEEDS = [bytes([i + 11]) * 32 for i in range(3)]


def test_rep3_proof_at_domain_128_verifies(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    try:
        zkey, w = setup.synthetic_zkey(126)
        assert zkey.domain_size == 128
        ni = zkey.n_public + 1
        assert len(zkey.a_query) - ni > 64  # Pippenger, not _msm_small
        path = tmp_path / "chain.circom"
        path.write_text(setup.chain_circom(126))
        prog = lang.load_program(str(path))
        inputs = shared.split_input_rep3(zkey.fr, {"x": 3}, random.Random(3))

        def party(net):
            tree = mpc_run.shared_input_to_tree(json.loads(inputs[net.id]),
                                                zkey.fr, net.id)
            wit, n_inst, drv = mpc_run.run_rep3_witness_extension(
                prog, zkey.fr, tree, net, seed=SEEDS[net.id])
            f = shared.read_shared_witness(shared.write_shared_witness(
                mpc_run.to_shared_witness_file(drv.pr, zkey.fr, wit, n_inst,
                                               net.id)))
            state = rep3.Rep3State.setup(net, SEEDS[net.id])
            proof = prove.prove(drivers.Rep3Driver(net, state), zkey,
                                prove.SharedWitness(
                                    f.public_inputs,
                                    rep3.Share(f.share_a, f.share_b)))
            return proof, f

        res = run_parties([party] * 3)
    finally:
        ct.set_default_device(None)
        torch.set_num_threads(threads)
    files = [r[1] for r in res]
    assert [f.public_inputs for f in files] == [w[:ni]] * 3
    assert rep3.combine_field_elements(
        zkey.fr, [rep3.Share(f.share_a, f.share_b) for f in files]) == w[ni:]
    proofs = [r[0] for r in res]
    assert proofs[0] == proofs[1] == proofs[2]
    vk = prove.vk_from_zkey(zkey)
    assert verify_bn254(vk, proofs[0], w[1:ni])
