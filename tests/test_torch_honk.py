"""The port's UltraHonk stack (cosnarks_tpu_torch.honk) against the JAX
package's (cosnarks_tpu.honk), on the CPU, on inputs from numpy / random
seeds and on synthetic Noir programs made in the test:

- the transcript in both flavors word for word, and the Poseidon2 t = 4
  permutation KAT (mpc-core poseidon2_permutation.rs:366);
- local_crs(8) made on the device equals the host's, through .dat files
  both ways;
- every tensor polyops function equals its list version;
- relations.accumulate on random rows: all 28 subrelations;
- the builder's trace and the proving key's polynomials (selectors,
  sigma / id, lookup tables, read counts and tags) on a program with
  RANGE, AND / XOR, Poseidon2 and ROM;
- plain proofs at 128 rows word for word in both flavors, from the port's
  key and from the JAX package's key carried across
  (convert.honk_proving_key_from_numpy); both verifiers accept them and
  refuse a changed word;
- one commitment through msm() on the CPU (the kernels' plain versions:
  the card's route) equals the JAX package's commit;
- a CRS on another device than the coefficients or the key is refused.
"""

import dataclasses
import random
import types

import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.honk import builder as jbuilder
from cosnarks_tpu.honk import crs as jcrs
from cosnarks_tpu.honk import polyops as jpolyops
from cosnarks_tpu.honk import prover as jprover
from cosnarks_tpu.honk import proving_key as jpk
from cosnarks_tpu.honk import relations as jrelations
from cosnarks_tpu.honk import transcript as jtranscript
from cosnarks_tpu.honk import verifier as jverifier
from cosnarks_tpu.noir import acir as jacir
from cosnarks_tpu_torch import convert
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.honk import builder, co_prover, crs, polyops, prover
from cosnarks_tpu_torch.honk import proving_key as hpk
from cosnarks_tpu_torch.honk import relations, transcript, verifier
from cosnarks_tpu_torch.noir import acir, solver, synthetic
from cosnarks_tpu_torch.vm import interp

R = BN254_FR.p

SMALL = dict(n_inputs=4, n_square=1, n_linear=1, n_big=1, n_range=0,
             n_logic=0, n_poseidon=1, n_reads=1)  # 128 rows
WIDE = dict(n_inputs=6, n_square=4, n_linear=4, n_big=2, n_range=3,
            n_logic=2, n_poseidon=1, n_reads=4)  # 2^14 rows: the tables


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _program(tmp_path, kw, seed):
    """(artifact path, plain witness list, AcirFormat of each package)."""
    path = str(tmp_path / "prog.json")
    acir.dump_artifact(path, *synthetic.synthetic_program(**kw))
    art = acir.load_artifact(path)
    af = builder.AcirFormat.from_function(art.functions[0])
    wmap = solver.solve_program(art, interp.PlainDriver(BN254_FR), R,
                                synthetic.synthetic_inputs(kw["n_inputs"],
                                                           seed))
    wit = [int(wmap.get(i, 0)) for i in range(af.max_witness_index + 1)]
    jaf = jbuilder.AcirFormat.from_function(
        jacir.load_artifact(path).functions[0])
    return path, wit, af, jaf


# -- transcript -------------------------------------------------------------

def test_poseidon2_t4_permutation_kat():
    out = transcript._POS.permutation(transcript._POS_DRIVER, [0, 1, 2, 3])
    assert out == [
        0x01bd538c2ee014ed5141b29e9ae240bf8db3fe5b9a38629a9647cf8d76c01737,
        0x239b62e7db98aa3a2a8f6a0d2fa1709e7a35959aa6c7034814d9daa90cbac662,
        0x04cbb44c61d928ed06808456bf758cbf0c18d1e15a7b6dbc8245fa7515d5e3cb,
        0x2e11c5cff2a22c64d01304b778d78f6998eff1ab73163a35603f54794c30847a,
    ]


@pytest.mark.parametrize("flavor", ["poseidon2", "keccak"])
def test_transcript_matches(flavor):
    rng = random.Random(4)
    mine = transcript.Transcript(transcript.HASHERS[flavor])
    theirs = jtranscript.Transcript(jtranscript.HASHERS[flavor])
    pt = crs.local_crs(2).monomials[1]
    a, bs = rng.randrange(R), [rng.randrange(R) for _ in range(5)]
    chals = []
    for t in (mine, theirs):
        t.add_u64_to_independent_hash_buffer("n", 7)
        t.add_point_to_independent_hash_buffer("c", pt)
        h = t.hash_independent_buffer()
        t.add_fr_to_hash_buffer("vk", h)
        t.send_fr("a", a)
        t.send_frs("bs", bs)
        t.send_point("P", pt)
        t.send_point("Inf", None)
        chals.append([h, t.get_challenge("x"),
                      t.get_challenges(["b", "g", "e"]),
                      t.get_powers_of_challenge("p", 5)])
    assert chals[0] == chals[1]
    assert mine.get_proof() == theirs.get_proof()
    back = transcript.Transcript(transcript.HASHERS[flavor],
                                 proof=mine.get_proof())
    back.add_fr_to_hash_buffer("vk", chals[0][0])
    assert back.receive_fr("a") == a
    assert back.receive_frs("bs", 5) == bs
    assert back.receive_point("P") == pt
    assert back.receive_point("Inf") is None
    assert back.get_challenge("x") == chals[0][1]


# -- CRS --------------------------------------------------------------------

def test_local_crs_on_device_and_dat_roundtrip(tmp_path):
    mine = crs.local_crs(8, device="cpu")
    theirs = jcrs.local_crs(8)
    assert mine.monomials == theirs.monomials
    assert mine.g2_x == theirs.g2_x
    assert mine.device == torch.device("cpu")
    assert crs.local_crs(8).points is None  # the host construction
    crs._check_local_crs(mine)
    g1m, g2m = str(tmp_path / "m_g1.dat"), str(tmp_path / "m_g2.dat")
    g1j, g2j = str(tmp_path / "j_g1.dat"), str(tmp_path / "j_g2.dat")
    crs.write_g1_dat(g1m, mine.monomials)
    crs.write_g2_dat(g2m, mine.g2_x)
    jcrs.write_g1_dat(g1j, theirs.monomials)
    jcrs.write_g2_dat(g2j, theirs.g2_x)
    assert open(g1m, "rb").read() == open(g1j, "rb").read()
    assert open(g2m, "rb").read() == open(g2j, "rb").read()
    assert jcrs.read_g1_dat(g1m, 8) == mine.monomials
    assert crs.read_g1_dat(g1j, 8) == theirs.monomials
    assert crs.read_g2_dat(g2j) == jcrs.read_g2_dat(g2m) == mine.g2_x
    assert crs.read_g2_dat() == jcrs.read_g2_dat()  # the bundled [tau]_2


# -- polyops ----------------------------------------------------------------

def test_polyops_tensors_match_list_versions():
    rng = np.random.default_rng(3)

    def vals(k):
        return [int(v) % R for v in rng.integers(0, 2**63, (k, 4)).dot(
            [1, 2**63, 2**126, 2**189])]

    v = vals(37)
    v[3] = v[10] = 0
    t = polyops.encode(v, "cpu")
    assert polyops.decode(t) == v
    assert polyops.decode(polyops.batch_invert(t)) == jpolyops.batch_invert(v)
    assert polyops.batch_invert_ints(v) == jpolyops.batch_invert(v)
    assert polyops.decode(polyops.shifted(t)) == v[1:] + [0]
    dst, s = vals(50), vals(1)[0]
    expect = list(dst)
    jpolyops.add_scaled(expect, v, s)
    assert polyops.decode(polyops.add_scaled(polyops.encode(dst, "cpu"), t,
                                             s)) == expect
    m, pts = vals(32), vals(5)
    assert polyops.evaluate_mle(polyops.encode(m, "cpu"), pts) == \
        jpolyops.evaluate_mle(m, pts)
    x = vals(1)[0]
    assert polyops.decode(polyops.evaluate_t(t, x)) == \
        [jpolyops.eval_poly(v, x)]
    assert polyops.decode(polyops.sum_rows(t)[None]) == [sum(v) % R]
    for root in (x, 0):
        w = list(v)
        w[0] = (w[0] - jpolyops.eval_poly(v, root)) % R
        assert polyops.decode(polyops.factor_roots(
            polyops.encode(w, "cpu"), root)) == jpolyops.factor_roots(w, root)
    ev = vals(6)
    assert polyops.extend_univariate(ev, 9) == \
        jpolyops.extend_univariate(ev, 9)
    assert polyops.evaluate_univariate(ev, x) == \
        jpolyops.evaluate_univariate(ev, x)


# -- relations --------------------------------------------------------------

def test_relations_accumulate_random_rows():
    rng = random.Random(28)
    k = 8
    names = prover.ENTITY_ORDER
    rows = {name: [rng.randrange(R) for _ in range(k)] for name in names}
    params = {name: rng.randrange(R) for name in (
        "eta_1", "eta_2", "eta_3", "beta", "gamma", "public_input_delta")}
    scaling = [rng.randrange(R) for _ in range(k)]
    mine = relations.accumulate(
        {n: relations.FV(polyops.encode(v, "cpu")) for n, v in rows.items()},
        params, relations.FV(polyops.encode(scaling, "cpu")))
    theirs = jrelations.accumulate(
        {n: jrelations.FV(np.array(v, dtype=object))
         for n, v in rows.items()},
        params, jrelations.FV(np.array(scaling, dtype=object)))
    assert len(mine) == relations.NUM_SUBRELATIONS == 28
    for j, (a, b) in enumerate(zip(mine, theirs)):
        assert a.values() == [int(x) for x in b.a], f"subrelation {j}"
    # the verifier's path: the same formulas over python ints
    ints = relations.accumulate({n: v[0] for n, v in rows.items()}, params,
                                scaling[0])
    assert [c % R for c in ints] == [a.values()[0] for a in mine]


# -- builder and proving key -------------------------------------------------

def test_builder_trace_and_proving_key_match(tmp_path):
    _path, wit, af, jaf = _program(tmp_path, WIDE, 11)
    b = builder.UltraBuilder.create_circuit(af, wit)
    jb = jbuilder.UltraBuilder.create_circuit(jaf, wit)
    for name in builder.BLOCK_ORDER:
        assert b.blocks[name].wires == jb.blocks[name].wires, name
        assert b.blocks[name].sel == jb.blocks[name].sel, name
    assert b.variables == jb.variables
    assert b.real_variable_index == jb.real_variable_index
    assert b.real_variable_tags == jb.real_variable_tags
    pk, jk = hpk.create_proving_key(b), jpk.create_proving_key(jb)
    assert pk.circuit_size == jk.circuit_size == 1 << 14
    assert set(pk.polynomials) == set(jk.polynomials)
    for name in jk.polynomials:  # selectors, sigma / id, tables, counts
        assert pk.polynomials[name] == jk.polynomials[name], name
    for field in ("public_inputs", "pub_inputs_offset",
                  "memory_read_records", "memory_write_records",
                  "final_active_wire_idx"):
        assert getattr(pk, field) == getattr(jk, field), field
    assert pk.active_region_data.ranges == jk.active_region_data.ranges
    assert any(pk.polynomials["q_lookup"])
    assert any(pk.polynomials["q_delta_range"])
    assert any(pk.polynomials["q_memory"])
    assert any(pk.polynomials["q_pos_int"])
    # the key carried across from numpy: the same limbs on the device
    moved = convert.honk_proving_key_from_numpy(jk, device="cpu")
    dev = pk.to_device("cpu")
    for name in ("w_l", "sigma_1", "table_3", "lookup_read_counts"):
        assert torch.equal(moved.polynomials[name], dev.polynomials[name])
    assert polyops.decode(moved.polynomials["id_2"]) == jk.polynomials["id_2"]
    # a polynomial given as (n, 16) uint32 Montgomery limbs, as the JAX
    # package holds field vectors on its device, is taken as limbs
    limbs = dict(jk.polynomials)
    limbs["q_m"] = dev.polynomials["q_m"].numpy().astype(np.uint32)
    as_limbs = convert.honk_proving_key_from_numpy(
        dataclasses.replace(jk, polynomials=limbs), device="cpu")
    assert torch.equal(as_limbs.polynomials["q_m"], dev.polynomials["q_m"])


# -- plain proofs -----------------------------------------------------------

@pytest.fixture(scope="module")
def small_keys(tmp_path_factory):
    """The 128-row program's keys in both packages, on one local CRS."""
    _path, wit, af, jaf = _program(tmp_path_factory.mktemp("honk"), SMALL,
                                   21)
    pk = hpk.create_proving_key(builder.UltraBuilder.create_circuit(af, wit))
    jk = jpk.create_proving_key(jbuilder.UltraBuilder.create_circuit(jaf,
                                                                     wit))
    assert pk.circuit_size == 128
    jc = jcrs.local_crs(pk.circuit_size)
    c = convert.honk_crs_from_numpy(jc)
    vk, jvk = hpk.create_vk(pk, c), jpk.create_vk(jk, jc)
    assert vk.commitments == jvk.commitments
    return pk, jk, c, jc, vk, jvk


@pytest.mark.parametrize("flavor", ["keccak", "poseidon2"])
def test_plain_proof_matches_and_verifies(small_keys, flavor):
    pk, jk, c, jc, vk, jvk = small_keys
    H, JH = transcript.HASHERS[flavor], jtranscript.HASHERS[flavor]
    theirs = jprover.prove(jk, jvk, jc, JH)
    # keccak from the port's own key, poseidon2 from the JAX key carried
    # across as tensors
    key = pk if flavor == "keccak" else \
        convert.honk_proving_key_from_numpy(jk, device="cpu")
    timings = {}
    mine = prover.prove(key, vk, c, H, timings=timings)
    assert set(timings) == {"oink", "sumcheck", "gemini", "shplonk", "kzg",
                            "turn_wait"}
    assert mine == theirs
    assert len(mine[0]) == (410 if flavor == "poseidon2" else
                            59 + 11 * 7 + 8)
    assert verifier.verify(mine[0], mine[1], vk, c.g2_x, H)
    assert jverifier.verify(mine[0], mine[1], jvk, jc.g2_x, JH)
    bad = list(mine[0])
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % R
    assert not verifier.verify(bad, mine[1], vk, c.g2_x, H)
    assert not jverifier.verify(bad, mine[1], jvk, jc.g2_x, JH)


def test_commit_through_msm_on_cpu(small_keys):
    """The card's route (msm() over device points; here the kernels' plain
    versions on CPU tensors) on a 64-coefficient polynomial with zeros."""
    _pk, _jk, c, jc, _vk, _jvk = small_keys
    rng = random.Random(64)
    coeffs = [0 if i % 5 == 0 else rng.randrange(R) for i in range(64)]
    on_cpu = c.to("cpu")
    assert on_cpu.device == torch.device("cpu")
    got = polyops.commit(polyops.encode(coeffs, "cpu"), on_cpu)
    assert got == jpolyops.commit(coeffs, jc)
    assert polyops.commit([0] * 8, on_cpu) is None


def test_commit_refuses_crs_on_another_device(small_keys):
    """A commitment never moves its work between devices: coefficients (or
    a proving key) on one device and a CRS on another raise, a host CRS
    counting as the CPU. The `meta` device stands in for the card."""
    pk, _jk, c, _jc, vk, _jvk = small_keys
    coeffs = polyops.encode([1, 2, 3], "cpu")
    on_cpu = c.to("cpu")
    for crs_ in (c, on_cpu):  # host CRS, CRS with CPU points
        with pytest.raises(ValueError, match="cannot commit"):
            polyops.commit(coeffs.to("meta"), crs_)
    with pytest.raises(ValueError, match="cannot commit"):
        polyops.commit_msm(coeffs.to("meta"), on_cpu)
    with pytest.raises(ValueError, match="cannot commit"):
        prover.prove(pk, vk, c, transcript.HASHERS["keccak"],
                     device="meta")
    with pytest.raises(ValueError, match="cannot commit"):
        co_prover.co_prove(pk, {}, vk, on_cpu, transcript.HASHERS["keccak"],
                           types.SimpleNamespace(device=torch.device("meta")))
    meta_key = dataclasses.replace(
        pk, polynomials={"q_m": coeffs.to("meta")})
    with pytest.raises(ValueError, match="cannot commit"):
        hpk.create_vk(meta_key, c)
    # the same device on both sides is taken
    polyops.check_crs_device(c, "cpu")
    polyops.check_crs_device(on_cpu, torch.device("cpu"))
