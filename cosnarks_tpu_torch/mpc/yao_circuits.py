"""Port of `cosnarks_tpu.mpc.yao_circuits`: host Python, copied unchanged.

Boolean circuits for the Yao engine, generic over garbler/evaluator.

Counterpart of the reference's GarbledCircuits (mpc-core/src/protocols/
rep3/yao/circuits.rs:17-965): the SAME python function both garbles and
evaluates — the `fancy` backend decides what xor/and/not mean — so the
gate order is structurally identical on both sides, which is the only
wire-format contract the engine has.

Values are either wire labels (int) or public constants (bool); constant
folding happens here so circuits never materialize constant wires except
via xor(w, w). Full adders/subtractors use the 1-AND majority form
(carry = c ^ ((a^c)&(b^c))) to keep the half-gate count minimal.
"""

from __future__ import annotations


def vxor(f, a, b):
    if isinstance(a, bool):
        a, b = b, a
    if isinstance(b, bool):
        if isinstance(a, bool):
            return a ^ b
        return f.not_(a) if b else a
    return f.xor(a, b)


def vand(f, a, b):
    if isinstance(a, bool):
        a, b = b, a
    if isinstance(b, bool):
        if isinstance(a, bool):
            return a and b
        return a if b else False
    return f.and_(a, b)


def vnot(f, a):
    if isinstance(a, bool):
        return not a
    return f.not_(a)


def full_add(f, a, b, c):
    """(sum, carry_out), 1 AND: carry = c ^ ((a^c) & (b^c))."""
    axc = vxor(f, a, c)
    bxc = vxor(f, b, c)
    s = vxor(f, axc, b)
    carry = vxor(f, c, vand(f, axc, bxc))
    return s, carry


def full_sub(f, a, b, bin_):
    """(diff, borrow_out) of a - b - bin: borrow = maj(~a, b, bin),
    1 AND via the same majority identity."""
    na = vnot(f, a)
    x = vxor(f, na, bin_)
    y = vxor(f, b, bin_)
    d = vxor(f, vxor(f, a, b), bin_)
    borrow = vxor(f, bin_, vand(f, x, y))
    return d, borrow


def ripple_add(f, xs, ys):
    """xs + ys, result has max(len)+1 bits. Shorter input zero-extended."""
    n = max(len(xs), len(ys))
    xs = list(xs) + [False] * (n - len(xs))
    ys = list(ys) + [False] * (n - len(ys))
    out = []
    c = False
    for a, b in zip(xs, ys):
        s, c = full_add(f, a, b, c)
        out.append(s)
    out.append(c)
    return out


def cond_sub_const(f, xs, const_bits):
    """xs >= C ? xs - C : xs, where C is a public constant.

    Computes the full borrow chain (1 AND/bit) then selects (1 AND/bit):
    out = diff ^ (borrow & (xs ^ diff))  — borrow=1 means xs < C."""
    diffs = []
    borrow = False
    for i, a in enumerate(xs):
        b = bool(const_bits[i]) if i < len(const_bits) else False
        d, borrow = full_sub(f, a, b, borrow)
        diffs.append(d)
    out = []
    for a, d in zip(xs, diffs):
        t = vxor(f, a, d)
        out.append(vxor(f, d, vand(f, borrow, t)))
    return out


def adder_mod_p_3(f, in0, in1, in2, pbits):
    """(in0 + in1 + in2) mod p for three < p inputs: two ripple adders +
    two conditional subtracts of the constant p (circuits.rs adder_mod_p,
    used by joint_input_arithmetic_added flows)."""
    n = len(in0)
    s = ripple_add(f, in0, in1)            # n+1 bits, < 2p
    s = ripple_add(f, s, in2)              # n+2 bits, < 3p
    s = cond_sub_const(f, s, pbits)        # < 2p
    s = cond_sub_const(f, s, pbits)        # < p
    return _materialize(f, s[:n], in0)


def xor_bundles_3(f, in0, in1, in2, _pbits=None):
    """Bitwise XOR of three bundles (b2y: recombining binary shares is
    free under free-XOR)."""
    return [vxor(f, vxor(f, a, b), c) for a, b, c in zip(in0, in1, in2)]


def unsigned_gt(f, xs, ys):
    """1 iff value(xs) > value(ys): the borrow-out of ys - xs
    (circuits.rs unsigned_gt via bin_subtraction_get_carry_only)."""
    borrow = False
    for a, b in zip(ys, xs):
        _, borrow = full_sub(f, a, b, borrow)
    return borrow


def batcher_sort_bundles(f, elems):
    """In-place ascending Batcher odd-even merge sort over equal-width
    bit bundles (circuits.rs batcher_odd_even_merge_sort_inner).

    Each compare-exchange: one unsigned_gt (1 AND/bit) + a cmux swap
    (1 AND/bit): lhs' = (cmp & (l^r)) ^ l, rhs' = (l^r) ^ lhs'."""
    n = len(elems)
    if n <= 1:
        return elems
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) != (i + j + k) // (2 * p):
                        continue
                    lhs = elems[i + j]
                    rhs = elems[i + j + k]
                    cmp = unsigned_gt(f, lhs, rhs)
                    lo, hi = [], []
                    for a, b in zip(lhs, rhs):
                        x = vxor(f, a, b)
                        l2 = vxor(f, vand(f, cmp, x), a)
                        lo.append(l2)
                        hi.append(vxor(f, x, l2))
                    elems[i + j] = lo
                    elems[i + j + k] = hi
            k >>= 1
        p <<= 1
    return elems


def batcher_sort_mod_p(f, triples, pbits, bitsize):
    """Joint circuit for the Rep3 field sort gadget: recombine each
    element's three additive shares mod p, truncate to the low `bitsize`
    bits, sort the truncated values ascending (circuits.rs
    batcher_odd_even_merge_sort, minus the in-circuit field composition
    — the caller composes via y2b + b2a instead of wires_c)."""
    elems = [
        adder_mod_p_3(f, t0, t1, t2, pbits)[:bitsize]
        for t0, t1, t2 in triples
    ]
    batcher_sort_bundles(f, elems)
    any_wires = [w for t in triples for w in t[0]]
    return [_materialize(f, e, any_wires) for e in elems]


def _materialize(f, bits, any_wires):
    """Replace constant outputs with real wires (y2b needs colors).

    If no real wire exists (fully-constant plain evaluation) the bools
    pass through unchanged."""
    wires = [w for w in any_wires if not isinstance(w, bool)]
    if not wires:
        return bits
    zero = None
    out = []
    for b in bits:
        if isinstance(b, bool):
            if zero is None:
                zero = f.xor(wires[0], wires[0])  # label 0 == semantic 0
            out.append(vnot(f, zero) if b else zero)
        else:
            out.append(b)
    return out
