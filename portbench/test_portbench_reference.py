"""The plain reference on its own, on the CPU at tiny sizes: its verifiers
accept a valid proof and refuse one with a changed coordinate, its MSM check
refuses a wrong point, and each function that counts work equals a count
made by hand."""

import numpy as np
import pytest
import torch

from portbench import trace, work
from portbench.reference import bn254, groth16, msm, plonk
from portbench.reference.bn254 import G1, G2, R

KEY_SEED = b"portbench-test-key"


def _groth16_proof(key, w):
    """A valid proof made with the toxic waste: A = [a], B = [b], C = [c]
    with a b = alpha beta + vk_x gamma + c delta in the exponent."""
    t = key.t
    a_val = (t["alpha"] + sum(w[i] * key.abc(i)[0] for i in range(len(w)))
             + 5 * t["delta"]) % R
    b_val = (t["beta"] + sum(w[i] * key.abc(i)[1] for i in range(len(w)))
             + 7 * t["delta"]) % R
    pub = sum(w[i] * key._lc(i) for i in range(groth16.N_PUBLIC + 1)) % R
    c_val = (a_val * b_val - t["alpha"] * t["beta"] - pub) \
        * pow(t["delta"], -1, R) % R
    return {"a": G1.mul(G1.gen, a_val), "b": G2.mul(G2.gen, b_val),
            "c": G1.mul(G1.gen, c_val)}


def test_groth16_verifier_accepts_and_refuses():
    ncon = 6
    key = groth16.ChainKey(KEY_SEED, ncon)
    w = groth16.chain_witness(11, ncon)
    vk = key.vk()
    proof = _groth16_proof(key, w)
    assert groth16.verify(vk, proof, w[1:2])
    x, y = proof["c"]
    assert not groth16.verify(vk, dict(proof, c=(x, (y + 1) % bn254.Q)),
                              w[1:2])
    assert not groth16.verify(vk, dict(proof, c=G1.neg(proof["c"])), w[1:2])
    assert not groth16.verify(vk, proof, [w[1] + 1])


def test_groth16_key_points_match_the_program():
    """The reference's key equals the program's synthetic_zkey from the
    same seed, point for point (the program is only the witness here)."""
    from cosnarks_tpu_torch.groth16 import setup

    ncon = 6
    zkey, _ = setup.synthetic_zkey(ncon, seed=KEY_SEED, device="cpu")
    key = groth16.ChainKey(KEY_SEED, ncon)
    for name in ("a_query", "b_g1_query", "c_query", "h_query"):
        arr = getattr(zkey, name)
        for i in range(len(arr)):
            assert bn254.decode_g1_affine_mont(arr[i]) == getattr(key, name)(i)
    for i in range(len(zkey.b_g2_query)):
        assert bn254.decode_g2_affine_mont(zkey.b_g2_query[i]) == \
            key.b_g2_query(i)
    vk = key.vk()
    assert [bn254.decode_g1_affine_mont(p) for p in zkey.ic] == vk["ic"]
    assert bn254.decode_g2_affine_mont(zkey.delta_g2) == vk["delta_g2"]


def test_plonk_verifier_accepts_and_refuses():
    """A proof of the program's plain prover on the benchmark's key."""
    from cosnarks_tpu_torch.ff import mont
    from cosnarks_tpu_torch.plonk import drivers
    from cosnarks_tpu_torch.plonk import prove as plonk_prove

    from portbench import plonk_fixture

    torch.set_num_threads(2)
    zk, wtns = plonk_fixture.build_zkey(4, 4, KEY_SEED, torch.device("cpu"))
    ni = zk.n_public + 1
    drv = drivers.PlainPlonkDriver(zk.fr, seed=3, device="cpu")
    proof = plonk_prove.prove(zk, drv, wtns[:ni],
                              mont.encode(zk.fr, wtns[ni:], device="cpu"))
    vk = plonk.vk(KEY_SEED, 4, 4)
    assert plonk.verify(vk, proof, wtns[1:ni])
    x, y, z = proof["Wxi"]
    bad = dict(proof, Wxi=[x, str((int(y) + 1) % bn254.Q), z])
    assert not plonk.verify(vk, bad, wtns[1:ni])
    assert not plonk.verify(vk, dict(proof, eval_a=str(int(proof["eval_a"])
                                                        + 1)), wtns[1:ni])


def test_msm_check_refuses_a_wrong_point():
    dlogs = [3, 5, 7, 11, 13]
    scalars = [bn254.MONT_R * s % R for s in (2, 4, 6, 8, 10)]  # Montgomery
    want = msm.expected(dlogs, scalars)
    direct = None
    for k, s in zip(dlogs, (2, 4, 6, 8, 10)):
        direct = G1.add(direct, G1.mul(G1.mul(G1.gen, k), s))
    assert want == direct
    assert want != G1.add(direct, G1.gen)
    assert want != msm.expected(dlogs[:-1] + [12], scalars)


def test_work_counts_by_hand():
    assert work.mont_mul_ops(8) == 4 * 64 + 8 == 264
    assert work.k1_work(3) == (3 * 264, 3 * 3 * 32)
    # 10 adds of level 0 over 2 lanes of 4 steps: in 8 affine points, out
    # 8 step sums and 2 x (run, prefix), projective
    assert work.k4_work(10, 2, 4, False) == (10 * 11 * 264,
                                             8 * 64 + 8 * 96 + 2 * 192)
    assert work.k4_work(10, 2, 4, True) == (10 * 16 * 264,
                                            8 * 96 + 8 * 96 + 2 * 192)
    # 1024 points of 8-bit scalars: one window of c = 8, 1024 adds into
    # 128 buckets and 2 x 128 to sum them
    assert work.pippenger_adds(1024, 8) == (1280, 8)
    assert work.msm_work(1024, 8) == (1280 * 11 * 264, 1024 * 96 + 96)
    peak = 132 * 64 * 1.98e9
    assert work.least_seconds(peak, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_trace_gaps_and_union():
    a, b = trace._merge(np.array([5, 0, 1, 6, 20]), np.array([7, 2, 3, 9, 21]))
    assert a.tolist() == [0, 5, 20] and b.tolist() == [3, 9, 21]
    empty = np.array([], dtype=np.int64)
    assert [x.tolist() for x in trace._merge(empty, empty)] == [[], []]
    # (start, duration, name): "inner" and "late" nest in "outer"
    host = [(40, 5, "late"), (0, 100, "outer"), (10, 10, "inner")]
    gap_a, gap_b = np.array([12, 30, 41, 200]), np.array([18, 34, 44, 210])
    assert trace._file_gaps(gap_a, gap_b, host) == pytest.approx(
        {"inner": 6e-9, "outer": 4e-9, "late": 3e-9, trace.OUTSIDE: 10e-9})
