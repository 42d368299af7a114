"""cosnarks_tpu_torch 3-party Rep3 Groth16 at synthetic_zkey(126) (domain
128), port only, on the CPU, from a witness of the port's circom VM: the
zkey's squaring chain, written as circom, runs through the Rep3 witness
extension into each party's .shared file, and the port's CLI proves from
the three files (generate-proof groth16 --local-parties 3) and verifies the
proof it wrote. Every G1 query MSM takes the Pippenger path through the K4
plain fold; all parties return one proof, and it verifies."""

import json
import random

import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu_torch import cli
from cosnarks_tpu_torch.groth16 import prove, setup
from cosnarks_tpu_torch.groth16.verify import verify_bn254
from cosnarks_tpu_torch.io import jsonio, shared, zkey as zkey_io
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.vm import lang, mpc_run

SEEDS = [bytes([i + 11]) * 32 for i in range(3)]


def test_rep3_proof_at_domain_128_verifies(tmp_path, monkeypatch):
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
            return shared.write_shared_witness(
                mpc_run.to_shared_witness_file(drv.pr, zkey.fr, wit, n_inst,
                                               net.id))

        paths = [tmp_path / f"witness.{i}.shared" for i in range(3)]
        for p, data in zip(paths, run_parties([party] * 3)):
            p.write_bytes(data)
        zkey_path = tmp_path / "chain.zkey"
        zkey_path.write_bytes(zkey_io.write_groth16_zkey(zkey))
        vk_path = tmp_path / "vk.json"
        vk_path.write_text(jsonio.vkey_to_json(prove.vk_from_zkey(zkey)))
        proofs = []  # every party's proof, as the CLI's prover returns it
        real_prove = prove.prove

        def recording_prove(*args, **kw):
            proofs.append(real_prove(*args, **kw))
            return proofs[-1]

        monkeypatch.setattr(prove, "prove", recording_prove)
        out, public = tmp_path / "proof.json", tmp_path / "public.json"
        cli.main(["generate-proof", "groth16", "--zkey", str(zkey_path),
                  "--witness", *map(str, paths), "--local-parties", "3",
                  "--out", str(out), "--public-input", str(public),
                  "--device", "cpu"])
        with pytest.raises(SystemExit) as verified:
            cli.main(["verify", "groth16", "--vk", str(vk_path), "--proof",
                      str(out), "--public-input", str(public),
                      "--device", "cpu"])
        files = [shared.read_shared_witness(p.read_bytes()) for p in paths]
    finally:
        ct.set_default_device(None)
        torch.set_num_threads(threads)
    assert [f.public_inputs for f in files] == [w[:ni]] * 3
    assert rep3.combine_field_elements(
        zkey.fr, [rep3.Share(f.share_a, f.share_b) for f in files]) == w[ni:]
    assert len(proofs) == 3
    assert proofs[0] == proofs[1] == proofs[2]
    written = jsonio.proof_from_json(out.read_text())
    assert all(written[k] == proofs[0][k] for k in ("a", "b", "c"))
    assert jsonio.public_from_json(public.read_text()) == w[1:ni]
    assert verified.value.code == 0
    vk = prove.vk_from_zkey(zkey)
    assert verify_bn254(vk, proofs[0], w[1:ni])
