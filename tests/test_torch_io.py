"""cosnarks_tpu_torch's artifact IO against cosnarks_tpu's, on the CPU: the
binary containers, .wtns / .r1cs / .sym / snarkjs JSON, the .shared files
(raw and seeded), the Groth16 and PLONK zkey parsers and the typed wire
format write and read the same bytes and values in both packages."""

import random
import struct
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu_torch import convert
from cosnarks_tpu.io import binformat as jbinformat
from cosnarks_tpu.io import jsonio as jjsonio
from cosnarks_tpu.io import r1cs as jr1cs
from cosnarks_tpu.io import shared as jshared
from cosnarks_tpu.io import sym as jsym
from cosnarks_tpu.io import wtns as jwtns
from cosnarks_tpu.io import zkey as jzkey
from cosnarks_tpu.mpc.net import wire as jwire
from cosnarks_tpu_torch.ff.spec import BLS12_381_FR, BN254_FR
from cosnarks_tpu_torch.groth16 import setup
from cosnarks_tpu_torch.io import (binformat, jsonio, r1cs, shared, sym, wtns,
                                  zkey)
from cosnarks_tpu_torch.io.binformat import limbs_to_le_bytes, write_container
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net import base, wire

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_plonk_fixture import plonk_fixture  # noqa: E402

FIELDS = [BN254_FR, BLS12_381_FR]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _values(field, k, seed):
    rng = random.Random(seed)
    return [1] + [rng.randrange(field.p) for _ in range(k - 1)]


def _limbs(field, values):
    from cosnarks_tpu_torch.ff.bigint import ints_to_limbs

    return ints_to_limbs(values, field.nlimbs)


# -- binformat --------------------------------------------------------------

def test_container_round_trip_and_parity():
    sections = [(1, b"\x01\x02\x03"), (7, b""), (2, bytes(range(40)))]
    data = write_container(b"test", 3, sections)
    assert data == jbinformat.write_container(b"test", 3, sections)
    c = binformat.Container(data, b"test")
    assert c.version == 3
    for stype, body in sections:
        assert bytes(c.section(stype)) == body
    assert c.sections == jbinformat.Container(data, b"test").sections
    with pytest.raises(ValueError):
        binformat.Container(data, b"zkey")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_limb_bytes_round_trip(field):
    limbs = _limbs(field, _values(field, 9, 1))
    raw = limbs_to_le_bytes(limbs)
    assert raw == jbinformat.limbs_to_le_bytes(limbs)
    n8 = 2 * field.nlimbs
    back = binformat.le_bytes_to_limbs(raw, n8)
    assert np.array_equal(back, limbs)
    assert np.array_equal(back, jbinformat.le_bytes_to_limbs(raw, n8))
    assert binformat.read_u32(struct.pack("<II", 5, 9), 4) == (9, 8)


# -- wtns / r1cs / sym / json -------------------------------------------------

@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_wtns_bytes_and_parse_match_jax(field):
    limbs = _limbs(field, _values(field, 17, 2))
    data = wtns.write_wtns(field, limbs)
    assert data == jwtns.write_wtns(field, limbs)
    prime, vals = wtns.parse_wtns(data)
    jprime, jvals = jwtns.parse_wtns(data)
    assert prime == jprime == field.p
    assert np.array_equal(vals, limbs) and np.array_equal(vals, jvals)


def _r1cs_bytes(field):
    """Two constraints over four wires, standard-form coefficients."""
    n8 = 2 * field.nlimbs
    header = (struct.pack("<I", n8) + limbs_to_le_bytes(_limbs(field, [field.p
                                                                       ]))
              + struct.pack("<IIIIQI", 4, 1, 1, 1, 5, 2))
    rng = random.Random(3)
    body = b""
    for _ in range(2):
        for m in range(3):
            wires = rng.sample(range(4), m + 1)
            body += struct.pack("<I", len(wires))
            for wire_id in wires:
                body += struct.pack("<I", wire_id) + limbs_to_le_bytes(
                    _limbs(field, [rng.randrange(field.p)]))
    return write_container(b"r1cs", 1, [(1, header), (2, body)])


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_r1cs_parse_matches_jax(field):
    data = _r1cs_bytes(field)
    got, ref = r1cs.parse_r1cs(data), jr1cs.parse_r1cs(data)
    for name in r1cs.R1CS.__dataclass_fields__:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype, name
        else:
            assert a == b, name
    assert got.n_public == ref.n_public == 2
    assert got.matrix.shape[0] == 2 * (1 + 2 + 3)


def test_sym_and_witness_map_match_jax(tmp_path):
    path = tmp_path / "circuit.sym"
    path.write_text("1,1,0,main.out\n2,-1,0,main.tmp\n3,2,0,main.in[0]\n"
                    "\n4,3,1,main.sub.x\n")
    got = sym.load_sym(str(path))
    assert got == jsym.load_sym(str(path)) == (
        {"main.out": 1, "main.in[0]": 2, "main.sub.x": 3}, 4)
    labels = ["one", "main.out", "main.tmp", "main.in[0]", "main.sub.x"]
    values = [1, 10, 20, 30, 40]
    assert (sym.map_witness(*got, labels, values)
            == jsym.map_witness(*got, labels, values) == [1, 10, 30, 40])
    with pytest.raises(ValueError):
        sym.map_witness(*got, labels[:3], values[:3])
    path.write_text("1,2,0\n")
    with pytest.raises(ValueError):
        sym.load_sym(str(path))


def test_jsonio_matches_jax():
    g1 = (5, 7)
    g2 = ((1, 2), (3, 4))
    proof = {"a": g1, "b": g2, "c": None}
    s = jsonio.proof_to_json(proof)
    assert s == jjsonio.proof_to_json(proof)
    assert jsonio.proof_from_json(s) == jjsonio.proof_from_json(s)
    assert jsonio.proof_from_json(s)["c"] is None
    vk = {"n_public": 1, "alpha_g1": g1, "beta_g2": g2, "gamma_g2": g2,
          "delta_g2": None, "ic": [g1, None]}
    v = jsonio.vkey_to_json(vk)
    assert v == jjsonio.vkey_to_json(vk)
    assert jsonio.vkey_from_json(v) == jjsonio.vkey_from_json(v)
    assert jsonio.public_to_json([1, 22]) == jjsonio.public_to_json([1, 22])
    assert jsonio.public_from_json(jsonio.public_to_json([1, 22])) == [1, 22]
    with pytest.raises(ValueError):
        jsonio.g1_from_json(["1", "2", "3"])


# -- .shared files ----------------------------------------------------------

def test_expand_seed_limbs_match_jax():
    seed = bytes(range(32))
    for field in FIELDS:
        got = shared.expand_seed(field, seed, 11).numpy()
        ref = np.asarray(jshared.expand_seed(field, seed, 11))
        assert np.array_equal(got, ref.astype(np.int64)), field.name


@pytest.mark.parametrize("seeded", [False, True], ids=["raw", "seeded"])
def test_rep3_shared_files_match_jax(seeded):
    field = BN254_FR
    w = _values(field, 12, 4)
    files = shared.split_witness_rep3(field, w, 3, random.Random(9),
                                      seeded=seeded)
    assert files == jshared.split_witness_rep3(field, w, 3, random.Random(9),
                                               seeded=seeded)
    read = [shared.read_shared_witness(f) for f in files]
    ref = [jshared.read_shared_witness(f) for f in files]
    for got, exp in zip(read, ref):
        assert got.public_inputs == exp.public_inputs == w[:3]
        assert np.array_equal(got.share_a.numpy(),
                              np.asarray(exp.share_a).astype(np.int64))
        assert np.array_equal(got.share_b.numpy(),
                              np.asarray(exp.share_b).astype(np.int64))
    shares = [rep3.Share(f.share_a, f.share_b) for f in read]
    assert rep3.combine_field_elements(field, shares) == w[3:]


def test_shamir_shared_files_match_jax():
    from cosnarks_tpu_torch.mpc import shamir

    field = BLS12_381_FR
    w = _values(field, 10, 5)
    files = shared.split_witness_shamir(field, w, 2, 3, 1, random.Random(8))
    assert files == jshared.split_witness_shamir(field, w, 2, 3, 1,
                                                 random.Random(8))
    read = [shared.read_shared_witness(f) for f in files]
    assert [f.party_id for f in read] == [0, 1, 2]
    assert read[0].share_b is None and read[0].threshold == 1
    assert shamir.combine_values(field, [f.share_a for f in read[:2]],
                                 [0, 1]) == w[2:]


def test_shared_inputs_match_jax():
    field = BN254_FR
    inputs = {"x": 5, "ys": [1, 2, 3], "pub": [7]}
    got = shared.split_input_rep3(field, inputs, random.Random(2), {"pub"})
    assert got == jshared.split_input_rep3(field, inputs, random.Random(2),
                                           {"pub"})
    merged = shared.merge_input_shares([got[0], got[0]])
    assert merged == jshared.merge_input_shares([got[0], got[0]])
    with pytest.raises(ValueError):
        shared.merge_input_shares([got[0], got[1]])


# -- zkeys ------------------------------------------------------------------

def _groth16_container(zk) -> bytes:
    """A snarkjs-layout Groth16 zkey of a Groth16Zkey's arrays."""
    def raw(a):
        return limbs_to_le_bytes(a.reshape(-1, a.shape[-1]))

    n8q, n8r = 2 * zk.fq.nlimbs, 2 * zk.fr.nlimbs
    header = b"".join([
        struct.pack("<I", n8q), raw(zk.fq.p_limbs[None]),
        struct.pack("<I", n8r), raw(zk.fr.p_limbs[None]),
        struct.pack("<III", zk.n_vars, zk.n_public, zk.domain_size),
        *(raw(getattr(zk, k)) for k in ("alpha_g1", "beta_g1", "beta_g2",
                                         "gamma_g2", "delta_g1",
                                         "delta_g2"))])
    coeffs = struct.pack("<I", len(zk.coeff_row)) + b"".join(
        struct.pack("<III", m, r, c) + raw(v[None])
        for m, r, c, v in zip(zk.coeff_matrix, zk.coeff_row, zk.coeff_col,
                              zk.coeff_val))
    sections = [(1, struct.pack("<I", zkey.GROTH16)), (2, header),
                (3, raw(zk.ic)), (4, coeffs)]
    sections += [(5 + i, raw(getattr(zk, k))) for i, k in enumerate(
        ("a_query", "b_g1_query", "b_g2_query", "c_query", "h_query"))]
    return write_container(b"zkey", 1, sections)


def _same_fields(got, ref, names):
    for name in names:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype, name
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                x, y = (x, y) if isinstance(x, tuple) else ((x,), (y,))
                assert all(np.array_equal(u, v) for u, v in zip(x, y)), name
        elif name in ("fq", "fr"):
            assert a.p == b.p, name
        else:
            assert a == b, name


def test_groth16_zkey_parse_matches_jax():
    zk, _ = setup.synthetic_zkey(30)
    data = _groth16_container(zk)
    got = zkey.parse_groth16_zkey(data)
    ref = jzkey.parse_groth16_zkey(data)
    names = list(zkey.Groth16Zkey.__dataclass_fields__)
    _same_fields(got, ref, names)
    _same_fields(got, zk, names)
    _same_fields(convert.zkey_from_numpy(ref), got, names)
    with pytest.raises(ValueError):
        zkey.parse_plonk_zkey(data)


def test_plonk_zkey_parse_matches_jax():
    data, vk, w = plonk_fixture(4, "bn254", 3, b"torch-plonk-test", "cpu")
    got = zkey.parse_plonk_zkey(data)
    ref = jzkey.parse_plonk_zkey(data)
    names = list(zkey.PlonkZkey.__dataclass_fields__)
    _same_fields(got, ref, names)
    carried = convert.plonk_zkey_from_numpy(ref)
    _same_fields(carried, got, names)
    assert carried.fr is got.fr and carried.fq is got.fq
    assert (got.domain_size, got.n_public, got.n_additions) == (16, 2, 3)
    assert got.n_vars == len(w) + 3 and len(got.lagrange) == 2
    assert got.p_tau.shape == (16 + 6, 2, 16)
    assert (got.k1, got.k2) == (2, 3) and vk["nPublic"] == 2
    with pytest.raises(ValueError):
        zkey.parse_groth16_zkey(data)


# -- wire format -------------------------------------------------------------

def _message(array):
    return {
        "arr": array(np.arange(12, dtype=np.uint32).reshape(3, 4)),
        "limbs": array(np.arange(-4, 20, dtype=np.int64).reshape(2, 12)),
        "flags": array(np.array([True, False])),
        "int": -(1 << 300),
        "list": [1, "two", None, True, b"\x00\xff"],
        "tup": (array(np.zeros(2, dtype=np.float64)), 5),
        7: "int key",
    }


def test_wire_bytes_match_jax():
    data = wire.encode(_message(torch.as_tensor))
    assert data == jwire.encode(_message(np.asarray))
    # a JAX array of a dtype JAX keeps without x64 (int32)
    assert (wire.encode([torch.arange(5, dtype=torch.int32)])
            == jwire.encode([jnp.arange(5, dtype=jnp.int32)]))
    assert base.to_wire(_message(torch.as_tensor)) == data
    share = rep3.Share(torch.arange(3), torch.arange(3, 6))
    assert wire.encode(share) == jwire.encode((np.arange(3), np.arange(3, 6)))


def test_wire_round_trip():
    msg = _message(torch.as_tensor)
    out = base.from_wire(wire.encode(msg))
    for key in ("arr", "limbs", "flags"):
        assert isinstance(out[key], np.ndarray)
        assert np.array_equal(out[key], msg[key].numpy())
        assert out[key].dtype == msg[key].numpy().dtype
    assert out["int"] == msg["int"] and out[7] == "int key"
    assert out["list"] == msg["list"]
    assert isinstance(out["tup"], tuple) and out["tup"][1] == 5
    ref = jwire.decode(wire.encode(msg))
    assert ref.keys() == out.keys()
    for key in ("arr", "limbs", "flags"):
        assert np.array_equal(out[key], ref[key])


def test_wire_rejects_bad_frames(monkeypatch):
    with pytest.raises(wire.WireError):
        wire.encode(object())
    with pytest.raises(wire.WireError):
        wire.encode(torch.zeros(2, dtype=torch.complex64))
    data = wire.encode([1, 2, 3])
    with pytest.raises(wire.WireError):
        wire.decode(data[:-1])
    with pytest.raises(wire.WireError):
        wire.decode(bytes([0x7F]))
    with pytest.raises(wire.WireError):
        wire.decode(data + b"\x00")
    with pytest.raises(wire.WireError):
        wire.decode(bytes([0x01, 0xFF, 0x00]))  # unknown dtype code
    monkeypatch.setattr(wire, "MAX_FRAME_LENGTH", 64)
    with pytest.raises(wire.WireError):
        wire.encode(np.zeros(100, dtype=np.uint8))
    with pytest.raises(wire.WireError):
        wire.decode(b"\x00" * 65)
    assert wire.decode(wire.encode([1, 2]), max_frame_length=1 << 20) == [1, 2]
