"""The port's Shamir co-UltraHonk (honk/shamir_honk.py) against the JAX
package's, on the CPU, three parties (n = 3, t = 1) over LocalNetwork:

- `shamir_share`, `_lagrange0` and `share_proving_key_shamir` give the JAX
  package's ints for the same `random.Random` seed;
- each driver operation, on shares of seeded values, opens to the plain
  values and to the JAX `ShamirHonkDriver`'s opened results (a commitment
  also when one party's partial point is the identity);
- a 128-row synthetic Noir program's proving key, Shamir-shared, is proved
  by `co_prove` over the driver (Poseidon2); every party's proof equals the
  JAX package's plain proof word for word, both verifiers accept it and
  refuse it with one word changed.
"""

import dataclasses
import random

import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.honk import builder as jbuilder
from cosnarks_tpu.honk import crs as jcrs
from cosnarks_tpu.honk import prover as jprover
from cosnarks_tpu.honk import proving_key as jpk
from cosnarks_tpu.honk import shamir_honk as jsh
from cosnarks_tpu.honk import transcript as jtranscript
from cosnarks_tpu.honk import verifier as jverifier
from cosnarks_tpu.mpc.net.local import run_parties as jrun_parties
from cosnarks_tpu.noir import acir as jacir
from cosnarks_tpu.noir import solver as jsolver
from cosnarks_tpu.ff.spec import BN254_FR as JFR
from cosnarks_tpu.vm import interp as jinterp
from cosnarks_tpu_torch import convert
from cosnarks_tpu_torch.ec import curves
from cosnarks_tpu_torch.ec.host import host_curve
from cosnarks_tpu_torch.honk import builder, co_prover, polyops
from cosnarks_tpu_torch.honk import crs as hcrs
from cosnarks_tpu_torch.honk import proving_key as hpk
from cosnarks_tpu_torch.honk import shamir_honk as sh
from cosnarks_tpu_torch.honk import transcript, verifier
from cosnarks_tpu_torch.mpc import shamir
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.noir import acir, synthetic

R = polyops.R
N, T = 3, 1
PROGRAM = dict(n_inputs=4, n_square=1, n_linear=1, n_big=1, n_range=0,
               n_logic=0, n_poseidon=1, n_reads=1)  # 128 rows
K = 8


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _state(net, seed):
    return shamir.ShamirState.setup(net, polyops.FR, T, pairs=16,
                                    seed=bytes([seed + net.id]) * 32,
                                    device="cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sharing_functions_match_jax(seed):
    rng = random.Random(seed)
    vals = [rng.randrange(R) for _ in range(5)] + [0, R - 1]
    a, b = random.Random(seed + 10), random.Random(seed + 10)
    for v in vals:
        assert sh.shamir_share(v, T, N, a) == jsh.shamir_share(v, T, N, b)
    xs = random.Random(seed).sample(range(1, 50), 4)
    assert sh._lagrange0(xs) == jsh._lagrange0(xs)


def test_share_proving_key_shamir_matches_jax(keys):
    pk, jk = keys[:2]
    got = sh.share_proving_key_shamir(pk, random.Random(4), 3, 1)
    want = jsh.share_proving_key_shamir(jk, random.Random(4), 3, 1)
    assert got == want
    for name in co_prover.SHARED_PK_ENTITIES:
        col = [sum(sh._lagrange0([1, 2, 3])[i] * got[i][name][j]
                   for i in range(3)) % R for j in range(len(got[0][name]))]
        assert col == [int(v) for v in pk.polynomials[name]]


def _values(seed, k=K, zero_at=()):
    rng = random.Random(seed)
    return [0 if i in zero_at else rng.randrange(1, R) for i in range(k)]


def _share_cols(vals, rng):
    """Per-party share lists of `vals` (degree t)."""
    cols = [[] for _ in range(N)]
    for v in vals:
        for i, s in enumerate(sh.shamir_share(v, T, N, rng)):
            cols[i].append(s)
    return cols


def _zero_partial_cols(vals):
    """Shares of `vals` whose polynomial v - v x vanishes at party 0's
    point: party 0's share is zero everywhere, so its partial commitment
    is the identity."""
    return [[(v - v * x) % R for v in vals] for x in range(1, N + 1)]


def _plain(op, x, y):
    if op in ("mul_vec", "mul_open"):
        return [a * b % R for a, b in zip(x, y)]
    if op == "open":
        return list(x)
    if op == "inv_vec":
        return [pow(a, -1, R) for a in x]
    if op == "inv_vec_leaking_zeros":
        return [pow(a, -1, R) if a else 0 for a in x]
    if op == "array_prod_mul":
        out, acc = [], 1
        for a in x:
            acc = acc * a % R
            out.append(acc)
        return out
    raise AssertionError(op)


def _port_op(op, xs, ys, crs):
    def party(net):
        drv = sh.ShamirHonkDriver(net, _state(net, 0x20))
        x = drv.to_share(xs[net.id], "cpu")
        y = drv.to_share(ys[net.id], "cpu")
        if op.startswith("commit_open"):
            return drv.commit_open(x, crs)
        if op == "open":
            return drv.open(x)
        if op == "mul_open":
            return polyops.decode(drv.mul_open(x, y))
        if op == "mul_vec":
            out = drv.mul_vec(drv.vec(x), drv.vec(y)).s
        else:
            out = getattr(drv, op)(x)
        return drv.open(out)

    return run_parties([party] * N)


def _jax_op(op, xs, ys, crs):
    def party(net):
        drv = jsh.ShamirHonkDriver(net, random.Random(0x30 + net.id), N, T)
        x = drv.from_shares(xs[net.id])
        y = drv.from_shares(ys[net.id])
        if op.startswith("commit_open"):
            return drv.commit_open(x, crs)
        if op == "open":
            return [int(v) for v in drv.open_vec(x)]
        if op == "mul_open":
            return [int(v) for v in drv.mul_open_vec(x, y)]
        if op == "mul_vec":
            out = drv.mul_vec(x, y)
        else:
            out = getattr(drv, op)(x)
        return [int(v) for v in drv.open_vec(out)]

    return jrun_parties([party] * N)


OPS = ("mul_vec", "open", "mul_open", "inv_vec", "inv_vec_leaking_zeros",
       "array_prod_mul", "commit_open", "commit_open_zero_partial")


@pytest.mark.parametrize("op", OPS)
def test_driver_op_matches_plain_and_jax(op):
    zero_at = (2, 5) if op == "inv_vec_leaking_zeros" else ()
    x = _values(11, zero_at=zero_at)
    y = _values(12)
    if op == "commit_open_zero_partial":
        xs = _zero_partial_cols(x)
        assert not any(xs[0])
    else:
        xs = _share_cols(x, random.Random(13))
    ys = _share_cols(y, random.Random(14))
    jc = jcrs.local_crs(K)
    crs = hcrs.local_crs(K, device="cpu")  # msm() on the CPU
    got = _port_op(op, xs, ys, crs)
    want = _jax_op(op, xs, ys, jc)
    assert got[0] == got[1] == got[2]
    assert want[0] == got[0]
    if op.startswith("commit_open"):
        g1 = host_curve(curves.BN254_G1)
        assert got[0] == g1.affine_ints(g1.msm(
            [g1.lift_affine(p) for p in jc.monomials], x))
    else:
        assert got[0] == _plain(op, x, y)


def test_inv_vec_refuses_zero():
    x = _values(21, zero_at=(3,))
    xs = _share_cols(x, random.Random(22))
    with pytest.raises(ZeroDivisionError):
        _port_op("inv_vec", xs, xs, None)


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """(port pk, JAX pk, JAX vk, JAX CRS) of the 128-row program."""
    path = str(tmp_path_factory.mktemp("shamir_honk") / "prog.json")
    acir.dump_artifact(path, *synthetic.synthetic_program(**PROGRAM))
    inputs = synthetic.synthetic_inputs(PROGRAM["n_inputs"], 44)
    jart = jacir.load_artifact(path)
    jaf = jbuilder.AcirFormat.from_function(jart.functions[0])
    jw = jsolver.solve_program(jart, jinterp.PlainDriver(JFR), R, inputs)
    wit = [int(jw.get(i, 0)) for i in range(jaf.max_witness_index + 1)]
    jk = jpk.create_proving_key(jbuilder.UltraBuilder.create_circuit(jaf, wit))
    assert jk.circuit_size == 128
    art = acir.load_artifact(path)
    af = builder.AcirFormat.from_function(art.functions[0])
    pk = hpk.create_proving_key(builder.UltraBuilder.create_circuit(af, wit))
    jc = jcrs.local_crs(jk.circuit_size)
    return pk, jk, jpk.create_vk(jk, jc), jc


def test_shamir_co_proof_equals_jax_plain_proof(keys):
    pk, jk, jvk, jc = keys
    H = jtranscript.HASHERS["poseidon2"]
    expect = jprover.prove(jk, jvk, jc, H)
    crs = convert.honk_crs_from_numpy(jc)  # a host CRS: the CPU's
    vk = hpk.create_vk(pk, crs)
    assert vk.commitments == jvk.commitments
    shares = sh.share_proving_key_shamir(pk, random.Random(45), N, T)
    pk = dataclasses.replace(pk, polynomials=dict(pk.polynomials))
    for name in co_prover.SHARED_PK_ENTITIES:
        pk.polynomials[name] = [0] * pk.circuit_size
    PH = transcript.HASHERS["poseidon2"]

    def party(net):
        drv = sh.ShamirHonkDriver(net, _state(net, 0x40))
        proof = co_prover.co_prove(pk, shares[net.id], vk, crs, PH, drv)
        return proof, drv.rounds, drv.refills

    res = run_parties([party] * N)
    assert res[0][0] == res[1][0] == res[2][0]
    assert res[0][0] == expect
    assert res[0][1] > 0 and res[0][2] > 0
    proof, pub = res[0][0]
    assert verifier.verify(proof, pub, vk, crs.g2_x, PH)
    assert jverifier.verify(proof, pub, jvk, jc.g2_x, H)
    bad = list(proof)
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % R
    assert not verifier.verify(bad, pub, vk, crs.g2_x, PH)
    assert not jverifier.verify(bad, pub, jvk, jc.g2_x, H)
