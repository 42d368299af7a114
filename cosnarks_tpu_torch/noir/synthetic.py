"""A synthetic Noir program, written as a real artifact file.

The repository carries no Noir corpus, so the coNoir path is driven by a
program made here: one private array input `x` of `n_inputs` 32-bit field
elements and one public return value. Its ACIR uses the opcodes the
UltraHonk builder supports:

- AssertZero: a multiply-add chain s_(i+1) = s_i^2 + x_(i mod n) (one mul
  term: one Rep3 multiplication in the co-ACVM), a linear chain
  t_(i+1) = 3 t_i + s_i + 5 (no multiplication) and big expressions of
  two products and five linear terms (split over several gates);
- BlackBoxFuncCall: 32-bit RANGE on inputs, 32-bit AND and XOR,
  Poseidon2Permutation (t = 4) on four chained values. The AND / XOR
  operands are the inputs when `logic_on_inputs`, else witnesses that an
  AssertZero fixes to 32-bit constants: the builder (like the JAX
  package's) has no logic gates on shared witnesses, so a program proved
  from a Rep3 witness keeps their operands public;
- MemoryInit of a ROM block from the inputs, MemoryOp reads at constant
  indices and at a witness index that the program fixes by an AssertZero.

`synthetic_program(...)` returns (abi, functions, brillig) for
`acir.dump_artifact`; `synthetic_inputs(n, seed)` returns the input
values. Sizes are parameters, so tests run it at tens of rows and the
chip smoke at 2^16 (`SMOKE_PROGRAM`).
"""

from __future__ import annotations

import random

from ..ff.spec import BN254_FR

R = BN254_FR.p

# the program of chip_smoke.py's phase rep3_noir_honk and of
# scripts/torch_honk_probe.py: 2^16 rows
SMOKE_PROGRAM = dict(n_inputs=64, n_square=4000, n_linear=28000, n_big=50,
                     n_range=32, n_logic=100, n_poseidon=40, n_reads=200)


def _fe(v: int) -> bytes:
    return (v % R).to_bytes(32, "big")


def _expr(mul=(), lin=(), qc=0):
    """Raw ACIR expression [mul terms, linear terms, constant]."""
    return [[[_fe(c), w1, w2] for c, w1, w2 in mul],
            [[_fe(c), w] for c, w in lin], _fe(qc)]


def _w(idx: int) -> dict:
    return {"Witness": idx}


def synthetic_program(n_inputs: int = 8, n_square: int = 16,
                      n_linear: int = 16, n_big: int = 2, n_range: int = 4,
                      n_logic: int = 2, n_poseidon: int = 1,
                      n_reads: int = 4, logic_on_inputs: bool = False):
    """(abi, [main function], brillig functions) of the synthetic
    program; see the module docstring."""
    assert n_inputs >= 4 and n_square >= 1
    ops = []
    nxt = n_inputs  # next free witness

    def new():
        nonlocal nxt
        nxt += 1
        return nxt - 1

    xs = list(range(n_inputs))
    # squaring chain: s_(i+1) - s_i^2 - x = 0
    s = xs[0]
    squares = []
    for i in range(n_square):
        out = new()
        ops.append({"AssertZero": _expr(
            mul=[(-1, s, s)], lin=[(-1, xs[i % n_inputs]), (1, out)])})
        s = out
        squares.append(out)
    # linear chain: t_(i+1) - 3 t_i - s_j - 5 = 0
    t = squares[-1]
    for i in range(n_linear):
        out = new()
        ops.append({"AssertZero": _expr(
            lin=[(-3, t), (-1, squares[i % len(squares)]), (1, out)],
            qc=-5)})
        t = out
    # big expressions: out = 2 a b + 7 c d + a + b + c + d + 11
    for i in range(n_big):
        a, b = xs[i % n_inputs], squares[i % len(squares)]
        c, d = xs[(i + 1) % n_inputs], t
        out = new()
        ops.append({"AssertZero": _expr(
            mul=[(-2, a, b), (-7, c, d)],
            lin=[(-1, a), (-1, b), (-1, c), (-1, d), (1, out)], qc=-11)})
        t = out
    # black boxes on the 32-bit inputs
    for i in range(n_range):
        ops.append({"BlackBoxFuncCall": {
            "RANGE": [_w(xs[i % n_inputs]), 32]}})
    logic_outs = []
    consts = random.Random(n_logic)
    for i in range(n_logic):
        if logic_on_inputs:
            a, b = xs[i % n_inputs], xs[(i + 1) % n_inputs]
        else:
            a, b = new(), new()
            for w in (a, b):
                ops.append({"AssertZero": _expr(
                    lin=[(1, w)], qc=-consts.getrandbits(32))})
        for name in ("AND", "XOR"):
            out = new()
            ops.append({"BlackBoxFuncCall": {
                name: [_w(a), _w(b), 32, out]}})
            logic_outs.append(out)
    state = [t, squares[0], xs[1], xs[2]]
    for _ in range(n_poseidon):
        outs = [new() for _ in range(4)]
        ops.append({"BlackBoxFuncCall": {"Poseidon2Permutation": [
            [_w(v) for v in state], outs, 4]}})
        state = outs
    # ROM: init from the inputs, reads at constants and at a witness index
    ops.append({"MemoryInit": [0, xs, "Memory"]})
    acc = state[0]
    for i in range(n_reads):
        val = new()
        if i % 2:
            idx = new()
            ops.append({"AssertZero": _expr(
                lin=[(1, idx)], qc=-((3 * i) % n_inputs))})
            index = _expr(lin=[(1, idx)])
        else:
            index = _expr(qc=(5 * i) % n_inputs)
        ops.append({"MemoryOp": [0, [_expr(), index, _expr(lin=[(1, val)])]]})
        out = new()
        ops.append({"AssertZero": _expr(lin=[(-1, acc), (-1, val), (1, out)])})
        acc = out
    # public return: the accumulator plus every logic output
    ret = new()
    ops.append({"AssertZero": _expr(
        lin=[(-1, acc)] + [(-1, o) for o in logic_outs] + [(1, ret)])})
    abi = {"parameters": [{
        "name": "x", "visibility": "private",
        "type": {"kind": "array", "length": n_inputs,
                 "type": {"kind": "field"}}}],
        "return_type": {"abi_type": {"kind": "field"},
                        "visibility": "public"},
        "error_types": {}}
    main = ["main", nxt - 1, ops, xs, [], [ret]]
    return abi, [main], []


def synthetic_inputs(n_inputs: int = 8, seed: int = 0) -> list[int]:
    """32-bit input values, from a seed."""
    rng = random.Random(seed)
    return [rng.getrandbits(32) for _ in range(n_inputs)]
