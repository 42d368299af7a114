"""The port's coNoir front end (cosnarks_tpu_torch.noir) against the JAX
package's (cosnarks_tpu.noir), on the CPU, on synthetic ACIR programs made
in the test (the repository has no Noir corpus):

- the port's own msgpack reader and writer give the installed `msgpack`'s
  bytes and objects;
- an artifact file written by the port parses to the same opcodes in both
  packages;
- the Brillig VM runs a small program (typed memory, casts, a call, Load /
  Store, a ToRadix black box, a JumpIf) to the JAX package's outputs,
  plain and with a shared branch condition (both universes, multiplexed);
- the co-ACVM solver, plain and 3-party Rep3, gives the JAX package's
  witness for AssertZero, RANGE, AND / XOR, Poseidon2, ROM memory and a
  BrilligCall; plain SHA-256 compression and Grumpkin EmbeddedCurveAdd,
  the curve add also on shared coordinates.
"""

import random

import msgpack
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.ec import host as jhost
from cosnarks_tpu.ec.curves import GRUMPKIN as JGRUMPKIN
from cosnarks_tpu.ff.spec import BN254_FR as JFR
from cosnarks_tpu.mpc import rep3_scalar as jrs
from cosnarks_tpu.mpc.net import local as jlocal
from cosnarks_tpu.noir import acir as jacir
from cosnarks_tpu.noir import brillig as jbrillig
from cosnarks_tpu.noir import solver as jsolver
from cosnarks_tpu.vm import interp as jinterp
from cosnarks_tpu.vm import rep3_driver as jrep3_driver
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.mpc import rep3_scalar as rs
from cosnarks_tpu_torch.mpc.net import local
from cosnarks_tpu_torch.noir import _msgpack, acir, brillig, solver, synthetic
from cosnarks_tpu_torch.vm import interp, rep3_driver

P = BN254_FR.p


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


# -- msgpack ----------------------------------------------------------------

def _random_obj(rng: random.Random, depth: int = 0):
    kinds = ["int", "str", "bin", "nil", "bool", "float"]
    if depth < 3:
        kinds += ["list", "dict"]
    kind = rng.choice(kinds)
    if kind == "int":
        edge = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                -2**31, -2**31 - 1, -2**63]
        return rng.choice(edge + [rng.randrange(-2**63, 2**64)])
    if kind == "str":
        return "".join(rng.choice("aé€z") for _ in range(
            rng.choice([0, 5, 31, 32, 255, 256, 70000])))
    if kind == "bin":
        return bytes(rng.getrandbits(8) for _ in range(
            rng.choice([0, 32, 255, 256, 65536])))
    if kind == "nil":
        return None
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "float":
        return rng.random() * 1e9
    n = rng.choice([0, 1, 15, 16, 17])
    if kind == "list":
        return [_random_obj(rng, depth + 1) for _ in range(n)]
    return {rng.choice([rng.randrange(10**6), f"k{rng.randrange(99)}"]):
            _random_obj(rng, depth + 1) for _ in range(n)}


def test_msgpack_matches_the_package():
    rng = random.Random(12)
    for _ in range(60):
        obj = _random_obj(rng)
        data = msgpack.packb(obj)
        assert _msgpack.packb(obj) == data
        assert _msgpack.unpackb(data) == msgpack.unpackb(
            data, strict_map_key=False)
    # a long array and map take their 16- and 32-bit headers
    for obj in (list(range(70000)), {i: i for i in range(70000)}):
        data = msgpack.packb(obj)
        assert _msgpack.packb(obj) == data
        assert _msgpack.unpackb(data) == obj
    with pytest.raises(_msgpack.MsgpackError):
        _msgpack.unpackb(msgpack.packb([1, 2])[:-1])
    with pytest.raises(_msgpack.MsgpackError):
        _msgpack.unpackb(b"\xc1")


# -- artifacts --------------------------------------------------------------

BRILLIG_FN = ["hint", [
    {"Const": [{"Direct": 1}, "Field", (2).to_bytes(32, "big")]},
    {"Const": [{"Direct": 2}, "Field", (0).to_bytes(32, "big")]},
    {"CalldataCopy": [{"Direct": 10}, {"Direct": 1}, {"Direct": 2}]},
    {"Cast": [{"Direct": 12}, {"Direct": 10}, {"Integer": "U32"}]},
    {"Cast": [{"Direct": 13}, {"Direct": 11}, {"Integer": "U32"}]},
    {"Call": [26]},
    {"BinaryIntOp": [{"Direct": 15}, "LessThan", "U32", {"Direct": 12},
                     {"Direct": 13}]},
    {"JumpIf": [{"Direct": 15}, 11]},
    {"BinaryIntOp": [{"Direct": 16}, "Xor", "U32", {"Direct": 12},
                     {"Direct": 13}]},
    {"BinaryFieldOp": [{"Direct": 17}, "Add", {"Direct": 10},
                       {"Direct": 11}]},
    {"Jump": [13]},
    {"BinaryIntOp": [{"Direct": 16}, "And", "U32", {"Direct": 12},
                     {"Direct": 13}]},
    {"BinaryFieldOp": [{"Direct": 17}, "Mul", {"Direct": 10},
                       {"Direct": 11}]},
    {"Const": [{"Direct": 20}, "Field", (60).to_bytes(32, "big")]},
    {"Store": [{"Direct": 20}, {"Direct": 17}]},
    {"Load": [{"Direct": 21}, {"Direct": 20}]},
    {"Mov": [{"Direct": 40}, {"Direct": 14}]},
    {"Mov": [{"Direct": 41}, {"Direct": 16}]},
    {"Mov": [{"Direct": 42}, {"Direct": 21}]},
    {"Const": [{"Direct": 3}, "Field", (16).to_bytes(32, "big")]},
    {"Const": [{"Direct": 4}, "Field", (43).to_bytes(32, "big")]},
    {"Const": [{"Direct": 5}, "Field", (4).to_bytes(32, "big")]},
    {"Const": [{"Direct": 6}, "Field", (0).to_bytes(32, "big")]},
    {"BlackBox": {"ToRadix": [{"Direct": 12}, {"Direct": 3}, {"Direct": 4},
                              {"Direct": 5}, {"Direct": 6}]}},
    {"Const": [{"Direct": 7}, "Field", (40).to_bytes(32, "big")]},
    {"Stop": [[{"Direct": 7}, {"Direct": 8}]]},
    # the called function: 14 <- 12 * 13 (u32), the output count in 8
    {"BinaryIntOp": [{"Direct": 14}, "Mul", "U32", {"Direct": 12},
                     {"Direct": 13}]},
    {"Const": [{"Direct": 8}, "Field", (7).to_bytes(32, "big")]},
    "Return",
]]
N_BRILLIG_OUT = 7


def _program_with_brillig(logic_on_inputs: bool):
    """The synthetic program (shared AND / XOR operands when
    `logic_on_inputs`) plus a BrilligCall of BRILLIG_FN on x0, x1."""
    abi, fns, _ = synthetic.synthetic_program(
        n_inputs=4, n_square=3, n_linear=3, n_big=1, n_range=2, n_logic=1,
        n_poseidon=1, n_reads=2, logic_on_inputs=logic_on_inputs)
    main = fns[0]
    outs = list(range(main[1] + 1, main[1] + 1 + N_BRILLIG_OUT))
    main[2].append({"BrilligCall": [
        0, [{"Single": synthetic._expr(lin=[(1, 0)])},
            {"Single": synthetic._expr(lin=[(1, 1)])}],
        [{"Array": outs}], None]})
    main[1] = outs[-1]
    return abi, fns, [BRILLIG_FN]


def _write(tmp_path, name, program):
    path = str(tmp_path / name)
    acir.dump_artifact(path, *program)
    return path


def test_artifact_parses_alike(tmp_path):
    path = _write(tmp_path, "prog.json", _program_with_brillig(True))
    mine, theirs = acir.load_artifact(path), jacir.load_artifact(path)
    assert mine.abi == theirs.abi
    assert mine.brillig == theirs.brillig
    (fm,), (fj,) = mine.functions, theirs.functions
    # Expression is a dataclass of each package: compare field by field
    assert [(k, repr(p)) for k, p in fm.opcodes] == \
        [(k, repr(p)) for k, p in fj.opcodes]
    assert (fm.private_params, fm.public_params, fm.return_values) == (
        fj.private_params, fj.public_params, fj.return_values)
    kinds = {k for k, _ in fm.opcodes}
    assert kinds == {"assert_zero", "blackbox", "memory_init", "memory_op",
                     "brillig_call"}
    inputs = synthetic.synthetic_inputs(4, 3)
    named = acir.encode_inputs(mine.abi, {"x": inputs}, P)
    assert named == jacir.encode_inputs(theirs.abi, {"x": inputs}, P)


# -- Brillig ----------------------------------------------------------------

def _rep3_run(fn_port, fn_jax, values: list, seed: int):
    """Run fn(driver, shares of values) on 3 port parties and on 3 JAX
    parties over their LocalNetworks with the same keys and input shares;
    returns the opened outputs of each package."""
    rng = random.Random(seed)
    shares = [jrs.Rep3Scalar.share(v, P, rand=lambda n: rng.randbytes(n))
              for v in values]
    keys = [bytes([seed + j]) * 32 for j in range(3)]

    def party(pkg_rs, drv_mod, field, fn):
        def go(net):
            k = net.id
            proto = pkg_rs.Rep3Scalar(
                net, pkg_rs.HostRng(keys[k], keys[(k + 1) % 3]), P)
            drv = drv_mod.Rep3Driver(proto, field)
            mine = [pkg_rs.AShare(s[k].a, s[k].b) for s in shares]
            out = fn(drv, mine)
            return [drv.open(v) if drv.is_shared(v) else int(v)
                    for v in out]
        return go

    port = local.run_parties([party(rs, rep3_driver, BN254_FR, fn_port)] * 3)
    jax = jlocal.run_parties(
        [party(jrs, jrep3_driver, JFR, fn_jax)] * 3)
    assert port[0] == port[1] == port[2]
    return [int(v) for v in port[0]], [int(v) for v in jax[0]]


def test_brillig_plain_and_shared_branch():
    for x, y in ((5, 9), (9, 5), (2**32 - 3, 7)):
        mine = brillig.BrilligVM(interp.PlainDriver(BN254_FR), P,
                                 [BRILLIG_FN]).run(0, [x, y])
        theirs = jbrillig.BrilligVM(jinterp.PlainDriver(JFR), P,
                                    [BRILLIG_FN]).run(0, [x, y])
        assert [int(v) for v in mine] == [int(v) for v in theirs]
        assert int(mine[0]) == x * y % 2**32
        assert int(mine[1]) == ((x & y) if x < y else (x ^ y))
        assert int(mine[2]) == ((x * y) if x < y else (x + y)) % P
    # a shared condition: both universes run and are multiplexed
    values = [0x1234567, 0x89ABCDE]
    port, jax = _rep3_run(
        lambda d, s: brillig.BrilligVM(d, P, [BRILLIG_FN]).run(0, s),
        lambda d, s: jbrillig.BrilligVM(d, P, [BRILLIG_FN]).run(0, s),
        values, 41)
    plain = brillig.BrilligVM(interp.PlainDriver(BN254_FR), P,
                              [BRILLIG_FN]).run(0, values)
    assert port == jax == [int(v) for v in plain]


# -- the solver ---------------------------------------------------------------

def _solve_plain(path, inputs):
    mine = solver.solve_program(acir.load_artifact(path),
                                interp.PlainDriver(BN254_FR), P, inputs)
    theirs = jsolver.solve_program(jacir.load_artifact(path),
                                   jinterp.PlainDriver(JFR), P, inputs)
    mine = {k: int(v) for k, v in mine.items()}
    assert mine == {k: int(v) for k, v in theirs.items()}
    return mine


def test_solver_plain_and_rep3(tmp_path):
    """AssertZero, RANGE, AND / XOR on shared inputs, Poseidon2, ROM reads
    at constant and witness indices, and a BrilligCall."""
    path = _write(tmp_path, "prog.json", _program_with_brillig(True))
    art, jart = acir.load_artifact(path), jacir.load_artifact(path)
    rng = random.Random(5)
    inputs = [rng.getrandbits(32) for _ in range(4)]
    plain = _solve_plain(path, inputs)
    n_wit = max(plain) + 1
    assert sorted(plain) == list(range(n_wit))

    def port_fn(d, s):
        wit = solver.solve_program(art, d, P, s)
        return [wit[i] for i in range(n_wit)]

    def jax_fn(d, s):
        wit = jsolver.solve_program(jart, d, P, s)
        return [wit[i] for i in range(n_wit)]

    port, jax = _rep3_run(port_fn, jax_fn, inputs, 7)
    assert port == jax == [plain[i] for i in range(n_wit)]


def _single_op_program(op, n_inputs: int, n_outputs: int):
    outs = list(range(n_inputs, n_inputs + n_outputs))
    abi = {"parameters": [{"name": "x", "visibility": "private", "type": {
        "kind": "array", "length": n_inputs, "type": {"kind": "field"}}}]}
    fn = ["main", outs[-1], [op(outs)], list(range(n_inputs)), [], []]
    return abi, [fn], []


def test_solver_sha256_compression(tmp_path):
    def op(outs):
        return {"BlackBoxFuncCall": {"Sha256Compression": [
            [synthetic._w(i) for i in range(16)],
            [synthetic._w(16 + i) for i in range(8)], outs]}}

    path = _write(tmp_path, "sha.json", _single_op_program(op, 24, 8))
    rng = random.Random(9)
    inputs = [rng.getrandbits(32) for _ in range(24)]
    wit = _solve_plain(path, inputs)
    assert all(wit[24 + i] < 2**32 for i in range(8))
    assert len({wit[24 + i] for i in range(8)}) == 8


def test_solver_embedded_curve_add(tmp_path):
    hc = jhost.host_curve(JGRUMPKIN)
    g = hc.lift_affine(JGRUMPKIN.generator)
    p1 = hc.affine_ints(hc.mul(g, 1234567))
    p2 = hc.affine_ints(hc.mul(g, 7654321))
    expect = hc.affine_ints(hc.mul(g, 1234567 + 7654321))

    def op(outs):
        return {"BlackBoxFuncCall": {"EmbeddedCurveAdd": [
            [synthetic._w(i) for i in range(3)],
            [synthetic._w(3 + i) for i in range(3)],
            {"Constant": (1).to_bytes(32, "big")}, outs]}}

    path = _write(tmp_path, "ec.json", _single_op_program(op, 6, 3))
    inputs = [p1[0], p1[1], 0, p2[0], p2[1], 0]
    wit = _solve_plain(path, inputs)
    assert (wit[6], wit[7], wit[8]) == (expect[0], expect[1], 0)
    # the infinity flag and a doubling
    wit = _solve_plain(path, [p1[0], p1[1], 0, 0, 0, 1])
    assert (wit[6], wit[7], wit[8]) == (p1[0], p1[1], 0)
    wit = _solve_plain(path, [p1[0], p1[1], 0, p1[0], p1[1], 0])
    assert (wit[6], wit[7]) == hc.affine_ints(hc.mul(g, 2 * 1234567))
    # shared coordinates: the branchless complete add
    art, jart = acir.load_artifact(path), jacir.load_artifact(path)

    def run(pkg_solver, artifact):
        def fn(d, s):
            wit = pkg_solver.solve_program(artifact, d, P, s)
            return [wit[6], wit[7], wit[8]]
        return fn

    port, jax = _rep3_run(run(solver, art), run(jsolver, jart), inputs, 61)
    assert port == jax == [expect[0], expect[1], 0]
