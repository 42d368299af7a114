"""Port of `cosnarks_tpu.gadgets.merkle`: host Python, copied unchanged
(only this docstring drops the JAX package's TPU remark).

Merkle trees with Poseidon2 in sponge mode, generic over the driver seam.

Counterpart of mpc-core/src/gadgets/merkle_tree/{plain,rep3,shamir}.rs: an
ARITY-ary tree where each node is the first sponge element after one
Poseidon2 permutation of [child_0..child_{ARITY-1}, 0...] (state width t >
arity). Unlike the reference (which permutes node-by-node and amortizes
MPC rounds with precomputed randomness), every level here is permuted as
ONE batch: all S-box multiplications across all nodes of the level travel
in a single `mul_many` round, so a level costs the same number of
communication rounds as a single permutation — the SIMD shape of the
same amortization.
"""

from __future__ import annotations

from .poseidon2 import Poseidon2


def _sbox_all(perm: Poseidon2, d, states: list[list], idxs=None):
    """One x^5 S-box over selected positions of every state, single round.

    idxs=None applies to all t positions (external round); idxs=[0] is the
    internal-round single-element S-box."""
    flat, backrefs = [], []
    for si, s in enumerate(states):
        for i in (range(perm.t) if idxs is None else idxs):
            flat.append(s[i])
            backrefs.append((si, i))
    x2 = d.mul_many(flat, flat)
    x4 = d.mul_many(x2, x2)
    x5 = d.mul_many(x4, flat)
    for (si, i), v in zip(backrefs, x5):
        states[si][i] = v
    return states


def permute_many(perm: Poseidon2, d, states: list[list]) -> list[list]:
    """Poseidon2 permutation of many states with cross-state S-box batching
    (round count independent of len(states))."""
    s = [list(st) for st in states]
    for st in s:
        perm._matmul_external(d, st)
    for r in range(perm.rounds_f // 2):
        for st in s:
            for i in range(perm.t):
                st[i] = d.add(st[i], perm.rc_ext[r][i])
        _sbox_all(perm, d, s)
        for st in s:
            perm._matmul_external(d, st)
    for r in range(perm.rounds_p):
        for st in s:
            st[0] = d.add(st[0], perm.rc_int[r])
        _sbox_all(perm, d, s, idxs=[0])
        for st in s:
            perm._matmul_internal(d, st)
    for r in range(perm.rounds_f // 2, perm.rounds_f):
        for st in s:
            for i in range(perm.t):
                st[i] = d.add(st[i], perm.rc_ext[r][i])
        _sbox_all(perm, d, s)
        for st in s:
            perm._matmul_external(d, st)
    return s


def _level_states(perm: Poseidon2, d, nodes: list, arity: int):
    zero = 0
    return [
        [*nodes[i : i + arity],
         *([zero] * (perm.t - arity))]
        for i in range(0, len(nodes), arity)
    ]


def merkle_root(perm: Poseidon2, d, leaves: list, arity: int = 2):
    """Root of the ARITY-ary Poseidon2 sponge tree over `leaves`
    (plain ints or shares via `d`). len(leaves) must be a power of arity."""
    if perm.t <= arity:
        raise ValueError("state width must exceed arity")
    n = len(leaves)
    log = 0
    while arity**log < n:
        log += 1
    if arity**log != n:
        raise ValueError("leaf count must be a power of the arity")
    nodes = list(leaves)
    while len(nodes) > 1:
        states = _level_states(perm, d, nodes, arity)
        out = permute_many(perm, d, states)
        nodes = [st[0] for st in out]
    return nodes[0]


def merkle_root_with_witness(perm: Poseidon2, d, leaves: list, index: int,
                             arity: int = 2):
    """Root plus the opening for `leaves[index]`: per level the sibling
    values and the position of the tracked element (MerkleWitnessElement,
    merkle_tree/plain.rs:5-11)."""
    nodes = list(leaves)
    witness = []
    i = index
    while len(nodes) > 1:
        pos = i % arity
        base = i - pos
        witness.append(
            {"other": [nodes[base + j] for j in range(arity) if j != pos],
             "position": pos}
        )
        states = _level_states(perm, d, nodes, arity)
        out = permute_many(perm, d, states)
        nodes = [st[0] for st in out]
        i //= arity
    return nodes[0], witness


def verify_merkle_opening(perm: Poseidon2, d, leaf, witness, arity: int = 2):
    """Recompute the root from a leaf and its opening."""
    cur = leaf
    for w in witness:
        children = list(w["other"])
        children.insert(w["position"], cur)
        st = [*children, *([0] * (perm.t - arity))]
        cur = permute_many(perm, d, [st])[0][0]
    return cur
