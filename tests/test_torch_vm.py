"""The port's circom witness extension (cosnarks_tpu_torch.vm) against the
JAX package's (cosnarks_tpu.vm), on the CPU, on small circom programs that
each test writes to its own directory: a squaring chain; templates,
functions, arrays, nested components and control flow on shared values;
circomlib-style Num2Bits, IsZero, AddBits and sqrt (the accelerated
components); comparisons, bit ops and log; and a violated constraint.

The plain VM gives the same witness, labels, instance count and logs. The
Rep3 VM, given the same HostRng keys and the same input shares, gives every
party the same witness share for share, and it recombines to the plain
witness; so do the Shamir VM (a seeded ShamirScalar rng, arithmetic
programs) and the batched Rep3 VM (B = 3 lanes). The chain's .shared
witness files are byte-identical in both packages and recombine to its
witness; tests/test_torch_groth16_port.py proves from such files."""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu.io import shared as jshared
from cosnarks_tpu.mpc import rep3_scalar as jrs
from cosnarks_tpu.mpc.net import local as jlocal
from cosnarks_tpu.vm import interp as jinterp
from cosnarks_tpu.vm import lang as jlang
from cosnarks_tpu.vm import mpc_run as jmpc_run
from cosnarks_tpu.vm import rep3_batched as jbatched
from cosnarks_tpu.vm import rep3_driver as jrep3_driver
from cosnarks_tpu.vm import shamir_driver as jshamir_driver
from cosnarks_tpu.vm import witness as jwitness
from cosnarks_tpu.ff.spec import BN254_FR as JBN254_FR
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.groth16 import setup
from cosnarks_tpu_torch.io import shared
from cosnarks_tpu_torch.mpc import rep3, rng as prng
from cosnarks_tpu_torch.mpc import rep3_scalar as rs
from cosnarks_tpu_torch.mpc.net import local
from cosnarks_tpu_torch.vm import (interp, lang, mpc_run, rep3_batched,
                                   rep3_driver, shamir_driver, witness)

F = BN254_FR
P = F.p
_Q = (P - 1) >> 28  # p - 1 = 2^28 q, q odd

CHAIN = setup.chain_circom(30)

STRUCTURE = """pragma circom 2.0.0;
function poly(x, k) {
    var acc = 0;
    for (var i = 0; i < k; i++) {
        acc = acc * x + i + 1;
    }
    return acc;
}
function choose(c, t, f) {
    if (c) {
        return t;
    }
    return f;
}
template Mul() {
    signal input a;
    signal input b;
    signal output c;
    c <== a * b;
}
template Dot(n) {
    signal input x[n];
    signal input y[n];
    signal output out;
    component m[n];
    var acc = 0;
    for (var i = 0; i < n; i++) {
        m[i] = Mul();
        m[i].a <== x[i];
        m[i].b <== y[i];
        acc += m[i].c;
    }
    out <== acc;
}
template Main(n) {
    signal input x[n];
    signal input y[n];
    signal input c;
    signal output out[3];
    component dot = Dot(n);
    for (var i = 0; i < n; i++) {
        dot.x[i] <== x[i];
        dot.y[i] <== y[i];
    }
    signal p;
    p <== poly(x[0], 3);
    var v;
    if (c) {
        v = dot.out;
    } else {
        v = x[1] + 7;
    }
    out[0] <-- v;
    out[0] === c * (dot.out - x[1] - 7) + x[1] + 7;
    out[1] <-- c ? x[0] * y[0] : y[1];
    out[2] <-- choose(c, x[2], y[2]);
    var w[2] = [x[0], y[0]];
    var k = 0;
    while (k < 2) {
        w[k] = w[k] + k;
        k++;
    }
    signal q;
    q <== w[0] * w[1];
}
component main {public [c]} = Main(3);
"""

# circomlib's sqrt (pointbits.circom), Num2Bits, IsZero and AddBits, with
# BN254 Fr's Tonelli-Shanks constants: c = 5^q, 5 a non-residue
CIRCOMLIB = """pragma circom 2.0.0;
function sqrt(n) {
    if (n == 0) {
        return 0;
    }
    var res = n ** ((-1) >> 1);
    if (res != 1) return 0;
    var m = 28;
    var c = %(c)d;
    var t = n ** %(q)d;
    var r = n ** ((%(q)d + 1) >> 1);
    var sq;
    var i;
    var b;
    var j;
    while ((r != 0) && (t != 1)) {
        sq = t * t;
        i = 1;
        while (sq != 1) {
            i++;
            sq = sq * sq;
        }
        b = c;
        for (j = 0; j < m - i - 1; j++) b = b * b;
        m = i;
        c = b * b;
        t = t * c;
        r = r * b;
    }
    if (r < 0) {
        r = -r;
    }
    return r;
}
template Num2Bits(n) {
    signal input in;
    signal output out[n];
    var lc1 = 0;
    var e2 = 1;
    for (var i = 0; i < n; i++) {
        out[i] <-- (in >> i) & 1;
        out[i] * (out[i] - 1) === 0;
        lc1 += out[i] * e2;
        e2 = e2 + e2;
    }
    lc1 === in;
}
template IsZero() {
    signal input in;
    signal output out;
    signal inv;
    inv <-- in != 0 ? 1 / in : 0;
    out <== -in * inv + 1;
    in * out === 0;
}
template AddBits(BITS) {
    signal input a[BITS];
    signal input b[BITS];
    signal output out[BITS];
    signal carrybit;
    var lin = 0;
    var lout = 0;
    var k;
    var j = 0;
    var e2 = 1;
    for (k = BITS - 1; k >= 0; k--) {
        lin += (a[k] + b[k]) * e2;
        e2 *= 2;
    }
    e2 = 1;
    for (k = BITS - 1; k >= 0; k--) {
        out[k] <-- (lin >> j) & 1;
        out[k] * (out[k] - 1) === 0;
        lout += out[k] * e2;
        e2 *= 2;
        j += 1;
    }
    carrybit <-- (lin >> j) & 1;
    carrybit * (carrybit - 1) === 0;
    lout += carrybit * e2;
    lin === lout;
}
template Lib(n) {
    signal input x;
    signal input y;
    signal input z;
    signal output bits[n];
    signal output isz[2];
    signal output sum[n];
    signal output root;
    component nb = Num2Bits(n);
    nb.in <== x;
    component ny = Num2Bits(n);
    ny.in <== y;
    for (var i = 0; i < n; i++) {
        bits[i] <== nb.out[i];
    }
    component z0 = IsZero();
    z0.in <== z;
    component z1 = IsZero();
    z1.in <== x - y;
    isz[0] <== z0.out;
    isz[1] <== z1.out;
    component add = AddBits(n);
    for (var i = 0; i < n; i++) {
        add.a[i] <== nb.out[n - 1 - i];
        add.b[i] <== ny.out[n - 1 - i];
    }
    for (var i = 0; i < n; i++) {
        sum[i] <== add.out[i];
    }
    root <-- sqrt(x * x);
    root * root === x * x;
}
component main = Lib(8);
""" % {"c": pow(5, _Q, P), "q": _Q}

OPS = """pragma circom 2.0.0;
template Ops() {
    signal input a;
    signal input b;
    signal output o[22];
    log("ops on", 2, "inputs");
    o[0] <-- a < b;
    o[1] <-- a <= b;
    o[2] <-- a > b;
    o[3] <-- a >= b;
    o[4] <-- a == b;
    o[5] <-- a != b;
    o[6] <-- a < 100;
    o[7] <-- 5 <= b;
    o[8] <-- a & b;
    o[9] <-- a | b;
    o[10] <-- a ^ b;
    o[11] <-- a & 255;
    o[12] <-- b | 12;
    o[13] <-- a ^ 5;
    o[14] <-- a >> 3;
    o[15] <-- a << 2;
    o[16] <-- a \\ 8;
    o[17] <-- a % 16;
    o[18] <-- ~a;
    o[19] <-- (a < 100) && (b > 5);
    o[20] <-- !(a == 7) || (b <= 3);
    o[21] <-- (a >> 2) & (b ^ 3);
}
component main = Ops();
"""

VIOLATED = """pragma circom 2.0.0;
template T() {
    signal input a;
    signal output b;
    b <-- a + 1;
    b === a + 2;
}
component main = T();
"""

SOURCES = {"chain": CHAIN, "structure": STRUCTURE, "circomlib": CIRCOMLIB,
           "ops": OPS}
# three inputs a program: the plain and Rep3 / Shamir runs take the first,
# the batched run all three as its lanes
INPUTS = {
    "chain": [{"x": 3}, {"x": 5}, {"x": 7}],
    "structure": [{"x": [2, 3, 4], "y": [5, 6, 7], "c": 1},
                  {"x": [9, 1, 8], "y": [2, 2, 3], "c": 0},
                  {"x": [P - 1, 3, 0], "y": [1, P - 2, 11], "c": 1}],
    "circomlib": [{"x": 77, "y": 200, "z": 0}, {"x": 31, "y": 31, "z": 9},
                  {"x": 255, "y": 1, "z": 1}],
    "ops": [{"a": 77, "b": 200}, {"a": 7, "b": 3}, {"a": 1000, "b": 1000}],
}
ARITHMETIC = ("chain", "structure")  # the Shamir VM has no bit ops
KEYS = [bytes([0x70 + j]) * 32 for j in range(3)]


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    ct.set_default_device("cpu")
    yield
    ct.set_default_device(None)
    torch.set_num_threads(threads)


def _load(tmp_path, name, src=None):
    """(port program, JAX program) of one source written to tmp_path."""
    path = tmp_path / f"{name}.circom"
    path.write_text(src or SOURCES[name])
    return lang.load_program(str(path)), jlang.load_program(str(path))


def _plain(prog, inputs):
    vm = interp.WitnessVM(prog, F)
    return witness.witness_vector(vm, vm.run(inputs))


def _flat(x):
    """A share, a numpy lane vector or a tree of them -> plain tuples and
    lists of ints, so both packages' values compare."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _flat(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return [int(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    return x


def _rep3_tree(inputs, seed, mk):
    """Per-party input trees of replicated shares, x0 and x1 drawn from
    random.Random(seed); mk(a, b) builds one package's AShare."""
    rnd = random.Random(seed)

    def rec(v):
        if isinstance(v, list):
            parts = [rec(u) for u in v]
            return [[q[i] for q in parts] for i in range(3)]
        x0, x1 = rnd.randrange(P), rnd.randrange(P)
        xs = [x0, x1, (int(v) - x0 - x1) % P]
        return [mk(xs[i], xs[(i + 1) % 3]) for i in range(3)]

    trees = [{}, {}, {}]
    for k, v in inputs.items():
        for i, r in enumerate(rec(v)):
            trees[i][k] = r
    return trees


def _both(port_party, jax_party):
    """One closure per party in each package, over each one's
    LocalNetwork."""
    return (local.run_parties([port_party] * 3),
            jlocal.run_parties([jax_party] * 3))


@pytest.mark.parametrize("name", SOURCES)
def test_plain_vm_matches_jax(tmp_path, name):
    prog, jprog = _load(tmp_path, name)
    inputs = INPUTS[name][0]
    vm, jvm = interp.WitnessVM(prog, F), jinterp.WitnessVM(jprog, JBN254_FR)
    main, jmain = vm.run(inputs), jvm.run(inputs)
    w = witness.witness_vector(vm, main)
    assert w == jwitness.witness_vector(jvm, jmain)
    assert (witness.witness_labels(vm, main)
            == jwitness.witness_labels(jvm, jmain))
    assert witness.n_public(vm, main) == jwitness.n_public(jvm, jmain)
    assert vm.main_outputs(main) == jvm.main_outputs(jmain)
    assert vm.logs == jvm.logs
    if name == "chain":
        assert w[:4] == [1, 3, 9, 81] and witness.n_public(vm, main) == 2
    if name == "ops":
        assert vm.logs == ["ops on 2 inputs"]


def test_generate_witness_matches_jax(tmp_path):
    path = tmp_path / "chain.circom"
    path.write_text(CHAIN)
    got = witness.generate_witness(str(path), {"x": 3}, F)
    assert got == jwitness.generate_witness(str(path), {"x": 3}, JBN254_FR)
    assert got[1] == 2 and len(got[0]) == 32


def test_generate_witness_sym_matches_jax(tmp_path):
    """A .sym file of a simplified artifact reorders and filters the
    witness the same way in both packages (vm/witness.py -> io/sym.py)."""
    path = tmp_path / "chain.circom"
    path.write_text(setup.chain_circom(3))
    sym = tmp_path / "chain.sym"
    # main.s[1] eliminated, main.s[0] and main.s[2] swapped
    sym.write_text("1,1,0,main.x\n2,3,0,main.s[0]\n3,-1,0,main.s[1]\n"
                   "4,2,0,main.s[2]\n")
    got = witness.generate_witness(str(path), {"x": 3}, F,
                                   sym_path=str(sym))
    assert got == jwitness.generate_witness(str(path), {"x": 3}, JBN254_FR,
                                            sym_path=str(sym))
    assert got == ([1, 3, 3 ** 8, 9], 2)


@pytest.mark.parametrize("a2b,name", [("direct", n) for n in SOURCES]
                         + [("yao", "ops")])
def test_rep3_vm_matches_jax(tmp_path, monkeypatch, a2b, name):
    """COSNARKS_A2B=yao routes the driver's arithmetic-to-binary
    conversions through the garbled adder (mpc/yao.py) in both packages."""
    monkeypatch.setenv("COSNARKS_A2B", a2b)
    prog, jprog = _load(tmp_path, name)
    inputs = INPUTS[name][0]
    trees = _rep3_tree(inputs, 0xA5, rs.AShare)
    jtrees = _rep3_tree(inputs, 0xA5, jrs.AShare)

    def party(pkg):
        scalar, driver, vm_mod, wit_mod, field, ts = pkg

        def go(net):
            k = net.id
            rng = scalar.HostRng(KEYS[k], KEYS[(k + 1) % 3])
            drv = driver.Rep3Driver(scalar.Rep3Scalar(net, rng, P), field)
            vm = vm_mod.WitnessVM(prog if vm_mod is interp else jprog,
                                  field, driver=drv, allow_logs=False)
            return wit_mod.witness_vector(vm, vm.run(ts[k]))
        return go

    res, jres = _both(party((rs, rep3_driver, interp, witness, F, trees)),
                      party((jrs, jrep3_driver, jinterp, jwitness,
                             JBN254_FR, jtrees)))
    for k in range(3):
        assert _flat(res[k]) == _flat(jres[k]), f"party {k}"
    assert any(isinstance(v, rs.AShare) for v in res[0])
    assert mpc_run.combine_witnesses(res, F) == _plain(prog, inputs)


@pytest.mark.parametrize("name", ARITHMETIC)
def test_shamir_vm_matches_jax(tmp_path, name):
    prog, jprog = _load(tmp_path, name)
    inputs = INPUTS[name][0]

    def tree(sd, seed):
        rnd = random.Random(seed)
        trees = [{}, {}, {}]

        def rec(v):
            if isinstance(v, list):
                parts = [rec(u) for u in v]
                return [[q[i] for q in parts] for i in range(3)]
            return sd.share_value(F, int(v), 3, 1, rng=rnd)

        for key, v in inputs.items():
            for i, r in enumerate(rec(v)):
                trees[i][key] = r
        return trees

    def party(sd, vm_mod, wit_mod, field, prg, ts):
        def go(net):
            pr = sd.ShamirScalar(net, field,
                                 rng=random.Random(0x5A + net.id))
            vm = vm_mod.WitnessVM(prg, field, driver=sd.ShamirVmDriver(
                pr, field))
            return wit_mod.witness_vector(vm, vm.run(ts[net.id]))
        return go

    res, jres = _both(
        party(shamir_driver, interp, witness, F, prog,
              tree(shamir_driver, 0x5B)),
        party(jshamir_driver, jinterp, jwitness, JBN254_FR, jprog,
              tree(jshamir_driver, 0x5B)))
    assert [_flat(r) for r in res] == [_flat(r) for r in jres]
    got = []
    for vals in zip(*res):
        if all(not isinstance(v, shamir_driver.SShare) for v in vals):
            got.append(int(vals[0]) % P)
        else:
            shs = [v if isinstance(v, shamir_driver.SShare)
                   else shamir_driver.SShare(int(v) % P) for v in vals]
            got.append(shamir_driver.combine_shares(F, shs, [0, 1, 2]))
    assert got == _plain(prog, inputs)


def test_shamir_vm_refuses_bit_ops(tmp_path):
    """Both packages' Shamir VM raise on a comparison of shared values."""
    prog, jprog = _load(tmp_path, "ops")
    shares = [shamir_driver.share_value(F, v, 3, 1, rng=random.Random(v))
              for v in (77, 200)]

    def party(sd, vm_mod, field, prg, mk):
        def go(net):
            drv = sd.setup_shamir_vm(net, field, t=1)
            vm = vm_mod.WitnessVM(prg, field, driver=drv, allow_logs=False)
            with pytest.raises(vm_mod.CircomError, match="Shamir"):
                vm.run({"a": mk(shares[0][net.id].v),
                        "b": mk(shares[1][net.id].v)})
            return True
        return go

    assert _both(party(shamir_driver, interp, F, prog, shamir_driver.SShare),
                 party(jshamir_driver, jinterp, JBN254_FR, jprog,
                       jshamir_driver.SShare)) == ([True] * 3, [True] * 3)


@pytest.mark.parametrize("name", SOURCES)
def test_batched_rep3_vm_matches_jax(tmp_path, name):
    B = 3
    prog, jprog = _load(tmp_path, name)
    lanes = INPUTS[name]

    def vec(vals):
        out = np.empty(len(vals), dtype=object)
        out[:] = [int(v) for v in vals]
        return out

    def lane_tree(mk):
        """Per-party trees of lane-vector shares drawn from a seed."""
        rnd = random.Random(0xB7)

        def rec(vs):
            if isinstance(vs[0], list):
                parts = [rec([v[i] for v in vs]) for i in range(len(vs[0]))]
                return [[q[k] for q in parts] for k in range(3)]
            x0 = vec([rnd.randrange(P) for _ in vs])
            x1 = vec([rnd.randrange(P) for _ in vs])
            xs = [x0, x1, (vec(vs) - x0 - x1) % P]
            return [mk(xs[i], xs[(i + 1) % 3]) for i in range(3)]

        trees = [{}, {}, {}]
        for key in lanes[0]:
            for i, r in enumerate(rec([d[key] for d in lanes])):
                trees[i][key] = r
        return trees

    def party(bt, vm_mod, wit_mod, field, prg, ts):
        def go(net):
            k = net.id
            rng = bt.BatchedHostRng(KEYS[k], KEYS[(k + 1) % 3], B)
            drv = bt.BatchedRep3Driver(bt.BatchedRep3Scalar(net, rng, P),
                                       field)
            vm = vm_mod.WitnessVM(prg, field, driver=drv, allow_logs=False)
            return wit_mod.witness_vector(vm, vm.run(ts[k]))
        return go

    res, jres = _both(
        party(rep3_batched, interp, witness, F, prog, lane_tree(rs.AShare)),
        party(jbatched, jinterp, jwitness, JBN254_FR, jprog,
              lane_tree(jrs.AShare)))
    for k in range(3):
        assert _flat(res[k]) == _flat(jres[k]), f"party {k}"
    wits = rep3_batched.combine_witnesses_batch(res, F, B)
    assert wits == jbatched.combine_witnesses_batch(jres, JBN254_FR, B)
    for lane in range(B):
        assert wits[lane] == _plain(prog, lanes[lane]), f"lane {lane}"


@pytest.mark.parametrize("mode", ["plain", "rep3"])
def test_violated_constraint_raises(tmp_path, mode):
    prog, jprog = _load(tmp_path, "violated", VIOLATED)
    for vm_mod, prg, driver, scalar, field in (
            (interp, prog, rep3_driver, rs, F),
            (jinterp, jprog, jrep3_driver, jrs, JBN254_FR)):
        if mode == "plain":
            with pytest.raises(vm_mod.CircomError,
                               match="constraint violated"):
                vm_mod.WitnessVM(prg, field).run({"a": 5})
            continue
        trees = _rep3_tree({"a": 5}, 1, scalar.AShare)

        def go(net, vm_mod=vm_mod, prg=prg, driver=driver, field=field,
               trees=trees):
            drv = driver.setup_rep3_vm(net, field, seed=KEYS[net.id])
            with pytest.raises(vm_mod.CircomError,
                               match="constraint violated"):
                vm_mod.WitnessVM(prg, field, driver=drv).run(trees[net.id])
            return True

        run = local.run_parties if vm_mod is interp else jlocal.run_parties
        assert run([go] * 3) == [True] * 3


def test_setup_rep3_vm_keys_match_jax():
    """setup_rep3_vm derives the same host streams in both packages, from a
    key exchange and from an existing PartyRng's keys."""
    from cosnarks_tpu.mpc import rng as jrng

    def go(pkg_driver, pkg_rng):
        def party(net):
            a = pkg_driver.setup_rep3_vm(net, F, seed=KEYS[net.id]).pr.rng
            pr = pkg_rng.PartyRng(KEYS[net.id], KEYS[(net.id + 1) % 3])
            b = pkg_driver.setup_rep3_vm(net, F, party_rng=pr).pr.rng
            return [(r._km, r._kn, r.pair(), r.zero_add(P)) for r in (a, b)]
        return party

    res, jres = _both(go(rep3_driver, prng), go(jrep3_driver, jrng))
    assert res == jres
    assert res[0][0][1] == res[1][0][0]  # party 0's next key is party 1's


def test_shared_input_tree_matches_jax():
    """split_input_rep3's per-party JSON -> VM input trees, in both
    packages; the trees recombine to the inputs."""
    inputs = {"x": 3, "ys": [5, P - 1]}
    parts = shared.split_input_rep3(F, inputs, random.Random(9),
                                    public_keys={"ys"})
    trees = [mpc_run.shared_input_to_tree(json.loads(s), F, i)
             for i, s in enumerate(parts)]
    jtrees = [jmpc_run.shared_input_to_tree(json.loads(s), JBN254_FR, i)
              for i, s in enumerate(parts)]
    assert _flat([list(t.items()) for t in trees]) == _flat(
        [list(t.items()) for t in jtrees])
    assert rs.Rep3Scalar.combine([t["x"] for t in trees], P) == 3
    assert trees[0]["ys"] == [5, P - 1]


def test_to_shared_witness_file_needs_a_card():
    """With no device asked for, to_shared_witness_file goes to cuda, and
    raises on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ct.set_default_device(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mpc_run.to_shared_witness_file(None, F, [1, 3, 9], 2, 0)
    finally:
        ct.set_default_device("cpu")


def test_chain_shared_witness_files_match_jax(tmp_path):
    """The chain at n = 30 through the Rep3 VM: each party's .shared file
    equals the JAX package's byte for byte, its opened instance is [1, 3],
    and the files recombine to the chain's witness (synthetic_zkey(30)'s:
    x = 3, then 30 squarings). tests/test_torch_groth16_port.py proves from
    such files."""
    prog, jprog = _load(tmp_path, "chain")
    parts = shared.split_input_rep3(F, {"x": 3}, random.Random(0xC4))

    def party(pkg_run, io, field, prg):
        def go(net):
            tree = pkg_run.shared_input_to_tree(json.loads(parts[net.id]),
                                                field, net.id)
            wit, n_inst, drv = pkg_run.run_rep3_witness_extension(
                prg, field, tree, net, seed=KEYS[net.id])
            return io.write_shared_witness(pkg_run.to_shared_witness_file(
                drv.pr, field, wit, n_inst, net.id))
        return go

    files, jfiles = _both(party(mpc_run, shared, F, prog),
                          party(jmpc_run, jshared, JBN254_FR, jprog))
    assert files == jfiles
    swfs = [shared.read_shared_witness(b, device="cpu") for b in files]
    assert [s.public_inputs for s in swfs] == [[1, 3]] * 3
    chain = [9]
    while len(chain) < 30:
        chain.append(chain[-1] ** 2 % P)
    assert rep3.combine_field_elements(
        F, [rep3.Share(s.share_a, s.share_b) for s in swfs]) == chain
