"""Port of `cosnarks_tpu.noir.solver`: host Python, copied unchanged.

co-ACVM: the ACIR opcode solver, generic over the witness-extension
driver seam (plain ints or Rep3 shares through the SAME driver the circom
VM uses — mirror of the reference's NoirWitnessExtensionProtocol,
co-noir/co-acvm/src/mpc.rs:22, solver loop solver.rs:347-383).

Supported opcodes: AssertZero (linear solve), BlackBoxFuncCall
{RANGE, AND, XOR, Poseidon2Permutation}, MemoryInit/MemoryOp with PUBLIC
indices. BrilligCall (unconstrained hints) and shared-index memory (LUT
gadgets) are staged next.
"""

from __future__ import annotations

from ..gadgets.poseidon2 import Poseidon2
from .acir import Expression, _finput


class UnsolvableError(Exception):
    pass


class CoSolver:
    def __init__(self, fn, driver, p: int, brillig_fns: list | None = None):
        self.fn = fn
        self.d = driver
        self.p = p
        self.witness: dict[int, object] = {}
        self.memory: dict[int, list] = {}
        self.brillig_fns = brillig_fns or []
        self._brillig_vm = None

    def set_inputs(self, values: list):
        for i, v in enumerate(values):
            self.witness[i] = self.d.norm(v)

    def _known(self, w: int) -> bool:
        return w in self.witness

    def solve(self):
        for kind, payload in self.fn.opcodes:
            getattr(self, "_op_" + kind, self._op_unknown)(payload)
        self.d.flush_asserts()
        return self.witness

    def _op_unknown(self, payload):
        raise UnsolvableError(f"unhandled opcode {payload!r:.80}")

    # -- AssertZero (assert_zero_solver.rs) ----------------------------------
    def _op_assert_zero(self, e: Expression):
        d = self.d
        acc = 0
        unknown = None
        ucoef = 0  # public int or share (mul term with one known shared)
        for c, w1, w2 in e.mul:
            k1, k2 = self._known(w1), self._known(w2)
            if k1 and k2:
                acc = d.add(acc, d.mul(c, d.mul(self.witness[w1],
                                                self.witness[w2])))
            elif k1 or k2:
                wk, wu = (w1, w2) if k1 else (w2, w1)
                if unknown is not None and unknown != wu:
                    raise UnsolvableError("two unknowns in expression")
                unknown = wu
                ucoef = d.add(ucoef, d.mul(c, self.witness[wk]))
            else:
                raise UnsolvableError("mul term with two unknowns")
        for c, w in e.lin:
            if self._known(w):
                acc = d.add(acc, d.mul(c, self.witness[w]))
            else:
                if unknown is not None and unknown != w:
                    raise UnsolvableError("two unknowns in expression")
                unknown = w
                ucoef = d.add(ucoef, c)
        acc = d.add(acc, e.qc)
        if unknown is None:
            d.assert_eq(acc, 0, " (AssertZero)")
            return
        if d.is_shared(ucoef):
            # shared coefficient: v = -acc / coef (one inversion round)
            self.witness[unknown] = d.norm(d.div(d.neg(acc), ucoef))
            return
        if ucoef % self.p == 0:
            raise UnsolvableError("unknown with zero coefficient")
        inv = pow(-ucoef % self.p, -1, self.p)
        self.witness[unknown] = d.norm(d.mul(acc, inv))

    # -- black boxes (blackbox_solver.rs:432-523) -----------------------------
    def _op_blackbox(self, payload):
        name, args = payload
        handler = getattr(self, "_bb_" + name.lower(), None)
        if handler is None:
            raise UnsolvableError(f"unhandled blackbox {name}")
        handler(args)

    def _in(self, v):
        kind, val = _finput(v)
        if kind == "c":
            return val % self.p
        if not self._known(val):
            raise UnsolvableError(f"blackbox input w{val} unknown")
        return self.witness[val]

    def _bb_recursiveaggregation(self, args):
        """No-op at witness-extension time (blackbox_solver.rs:523) — the
        recursion constraints act at proving time."""

    def _bb_range(self, args):
        value, num_bits = self._in(args[0]), int(args[1])
        if not self.d.is_shared(value):
            if int(value) >> num_bits:
                raise ValueError(
                    f"range check failed: {value} >= 2^{num_bits}")
        # shared values: the constraint system enforces the range at proof
        # time; witness extension needs no action (reference rep3 solver)

    def _bb_and(self, args):
        a, b, _nbits, out = (self._in(args[0]), self._in(args[1]),
                             int(args[2]), int(args[3]))
        self.witness[out] = self.d.norm(self.d.band(a, b))

    def _bb_xor(self, args):
        a, b, _nbits, out = (self._in(args[0]), self._in(args[1]),
                             int(args[2]), int(args[3]))
        self.witness[out] = self.d.norm(self.d.bxor(a, b))

    # -- ARX hash blackboxes (blackbox_solver.rs:493-523) --------------------
    def _hash_words(self, values, width: int):
        """Solver values -> (ops, words, to_value) for blackbox_hash.
        Plain values run on ints; any shared value lifts the whole call
        into the Rep3 binary domain (mpc-core's rep3 hash path)."""
        from . import blackbox_hash as bh

        if not any(self.d.is_shared(v) for v in values):
            return (bh.PlainWordOps(), [int(v) % self.p for v in values],
                    lambda ws: [int(w) for w in ws])
        pr = self.d.pr
        from ..mpc.rep3_scalar import BShare

        shares = [self.d.to_share(v) if self.d.is_shared(v)
                  else pr.promote(int(v)) for v in values]
        bs = pr.a2b_many(shares)
        mask = (1 << width) - 1
        words = [BShare(b.a & mask, b.b & mask, width) for b in bs]

        def to_values(ws):
            shared = [(i, w) for i, w in enumerate(ws)
                      if not isinstance(w, int)]
            out = list(ws)
            if shared:
                conv = pr.b2a_many([w for _, w in shared])
                for (i, _), v in zip(shared, conv):
                    out[i] = v
            return out

        return bh.Rep3WordOps(pr), words, to_values

    def _bb_sha256compression(self, args):
        from . import blackbox_hash as bh

        inputs = [self._in(v) for v in args[0]]
        state = [self._in(v) for v in args[1]]
        outs = [int(w) for w in args[2]]
        ops, words, to_values = self._hash_words(state + inputs, 32)
        res = to_values(bh.sha256_compression(ops, words[:8], words[8:]))
        for w, v in zip(outs, res):
            self.witness[w] = self.d.norm(v)

    def _bb_blake2s(self, args):
        from . import blackbox_hash as bh

        inputs = [self._in(v) for v in args[0]]
        outs = [int(w) for w in args[1]]
        ops, words, to_values = self._hash_words(inputs, 8)
        res = to_values(bh.blake2s(ops, words))
        for w, v in zip(outs, res):
            self.witness[w] = self.d.norm(v)

    def _bb_blake3(self, args):
        from . import blackbox_hash as bh

        inputs = [self._in(v) for v in args[0]]
        outs = [int(w) for w in args[1]]
        ops, words, to_values = self._hash_words(inputs, 8)
        res = to_values(bh.blake3(ops, words))
        for w, v in zip(outs, res):
            self.witness[w] = self.d.norm(v)

    def _bb_aes128encrypt(self, args):
        from . import blackbox_hash as bh

        inputs = [self._in(v) for v in args[0]]
        iv = [self._in(v) for v in args[1]]
        key = [self._in(v) for v in args[2]]
        outs = [int(w) for w in args[3]]
        if any(self.d.is_shared(v) for v in inputs + iv + key):
            # LUT S-box path: bytes live as 8-bit binary shares; the S-box
            # is an oblivious public-table read (mpc/rep3_ring.py)
            from ..mpc.rep3_ring import Rep3Ring
            from ..mpc.rep3_scalar import BShare

            d = self.d
            fp = d.pr
            ring = Rep3Ring(fp.net, fp.rng, 32)

            def to_bytes(vals):
                shared_idx = [i for i, v in enumerate(vals)
                              if d.is_shared(v)]
                bs = fp.a2b_many([d.to_share(vals[i])
                                  for i in shared_idx])
                out = [fp.bpromote(int(v) % 256)
                       if not d.is_shared(v) else None for v in vals]
                for i, bsh in zip(shared_idx, bs):
                    out[i] = BShare(bsh.a & 0xFF, bsh.b & 0xFF, 8)
                return out

            res = bh.aes128_encrypt_cbc_shared(
                ring, fp, to_bytes(inputs), to_bytes(iv), to_bytes(key))
            arith = fp.b2a_many([BShare(v.a, v.b, 8) for v in res])
            for w, v in zip(outs, arith):
                self.witness[w] = v
            return
        res = bh.aes128_encrypt_cbc([int(v) % self.p for v in inputs],
                                    [int(v) % self.p for v in iv],
                                    [int(v) % self.p for v in key])
        for w, v in zip(outs, res):
            self.witness[w] = self.d.norm(v)

    def _bb_poseidon2permutation(self, args):
        inputs = [self._in(v) for v in args[0]]
        outs = [int(w) for w in args[1]]
        perm = Poseidon2(len(inputs), self.p)
        res = perm.permutation(self.d, inputs)
        for w, v in zip(outs, res):
            self.witness[w] = self.d.norm(v)

    # -- Grumpkin embedded-curve blackboxes (plain path; the shared variant
    # routes through pointshare gadgets later) -------------------------------
    def _grumpkin(self):
        from ..ec import host
        from ..ec.curves import GRUMPKIN

        return host.host_curve(GRUMPKIN)

    def _ec_point(self, hc, xs):
        x, y, inf = (self._in(v) for v in xs)
        if any(self.d.is_shared(v) for v in (x, y, inf)):
            raise UnsolvableError("shared embedded-curve point")
        if int(inf):
            return None
        return (hc._lift(int(x)), hc._lift(int(y)))

    def _store_point(self, hc, pt, outs):
        ox, oy, oinf = (int(w) for w in outs)
        if pt is None:
            self.witness[ox] = 0
            self.witness[oy] = 0
            self.witness[oinf] = 1
        else:
            x, y = hc._lower(pt)
            self.witness[ox] = x
            self.witness[oy] = y
            self.witness[oinf] = 0

    def _bb_embeddedcurveadd(self, args):
        in1, in2, _pred, outs = args
        v1 = [self._in(v) for v in in1]
        v2 = [self._in(v) for v in in2]
        if any(self.d.is_shared(v) for v in v1 + v2):
            return self._embedded_add_shared(v1, v2, outs)
        hc = self._grumpkin()
        p1 = self._ec_point(hc, in1)
        p2 = self._ec_point(hc, in2)
        self._store_point(hc, hc.add(p1, p2), outs)

    def _embedded_add_shared(self, v1, v2, outs):
        """Complete Grumpkin affine add on SHARED coordinates: Grumpkin's
        base field is bn254-Fr, so point coords are ordinary protocol
        shares; branchless case handling (double / cancel / infinity) via
        shared predicates (reference co-acvm shared point ops, co-noir/
        co-acvm/src/mpc/rep3.rs embedded-curve path). Grumpkin has odd
        prime order, so no 2-torsion: 2*y1 == 0 only for the infinity
        placeholder, which the masks cover."""
        d = self.d
        rx, ry, ri = _shared_complete_add(
            d, tuple(d.norm(v) for v in v1),
            tuple(d.norm(v) for v in v2))
        ox, oy, oinf = (int(w) for w in outs)
        self.witness[ox] = d.norm(rx)
        self.witness[oy] = d.norm(ry)
        self.witness[oinf] = d.norm(ri)

    def _bb_multiscalarmul(self, args):
        points, scalars, _pred, outs = args
        hc = self._grumpkin()
        d = self.d
        acc = None          # public partial sum (host point)
        shared_pairs = []   # (public affine base, lo share, hi share)
        for i in range(0, len(points), 3):
            pt = self._ec_point(hc, points[i : i + 3])
            lo = self._in(scalars[2 * (i // 3)])
            hi = self._in(scalars[2 * (i // 3) + 1])
            if d.is_shared(lo) or d.is_shared(hi):
                if pt is None:
                    continue
                shared_pairs.append((hc._lower(pt), lo, hi))
                continue
            k = int(lo) + (int(hi) << 128)
            if pt is None or k == 0:
                continue
            term = hc.mul(pt, k)
            acc = term if acc is None else hc.add(acc, term)
        if not shared_pairs:
            self._store_point(hc, acc, outs)
            return
        sx, sy, sinf = shared_fixed_base_msm(d, shared_pairs, hc)
        if acc is not None:
            ax, ay = hc.affine_ints(acc)
            sx, sy, sinf = _shared_complete_add(d, (sx, sy, sinf),
                                                (ax, ay, 0))
        ox, oy, oinf = (int(w) for w in outs)
        self.witness[ox] = d.norm(sx)
        self.witness[oy] = d.norm(sy)
        self.witness[oinf] = d.norm(sinf)

    # -- memory (public indices; memory_solver.rs) ----------------------------
    def _op_memory_init(self, payload):
        block_id, witnesses, _type = payload
        self.memory[block_id] = [self.witness[w] for w in witnesses]

    def _eval_expr(self, e: Expression):
        d = self.d
        acc = e.qc
        for c, w1, w2 in e.mul:
            acc = d.add(acc, d.mul(c, d.mul(self.witness[w1],
                                            self.witness[w2])))
        for c, w in e.lin:
            acc = d.add(acc, d.mul(c, self.witness[w]))
        return acc

    def _ohv(self, idx, n: int):
        """One-hot vector of length >= n from a shared index: bit-decompose
        once, then log2(n) batched mul rounds (the reference's rep3_ring
        ohv gadget, rep3_ring/gadgets/ohv.rs)."""
        d = self.d
        k = max(1, (n - 1).bit_length())
        bits = d.num2bits(idx, k)  # LSB first, arithmetic bit shares
        ohv = [1]
        for b in reversed(bits):  # MSB first halves the index space
            nb = d.sub(1, b)
            both = d.mul_many(ohv + ohv, [nb] * len(ohv) + [b] * len(ohv))
            left, right = both[: len(ohv)], both[len(ohv):]
            ohv = [v for pair in zip(left, right) for v in pair]
        return ohv  # length 2^k; tail beyond n unused

    def _op_memory_op(self, payload):
        block_id, operation, index, value = payload
        d = self.d
        op = self._eval_expr(operation)
        if d.is_shared(op):
            raise UnsolvableError("shared memory operation flag")
        idx = self._eval_expr(index)
        block = self.memory[block_id]
        is_read = int(op) == 0
        if d.is_shared(idx):
            prov = getattr(d, "lut_provider", None)
            if prov is not None:
                # binary OHV-LUT gadget (mpc/lut.py; rep3_ring/lut_field.rs)
                block = [d.norm(v) for v in block]
                if is_read:
                    if (len(value.lin) == 1 and not value.mul
                            and value.qc == 0 and value.lin[0][0] == 1):
                        self.witness[value.lin[0][1]] = d.norm(
                            prov.read(idx, block))
                        return
                    raise UnsolvableError("complex memory read expression")
                new = d.norm(self._eval_expr(value))
                self.memory[block_id] = prov.write(idx, new, block)
                return
            # arithmetic one-hot fallback (batched driver)
            ohv = self._ohv(idx, len(block))[: len(block)]
            if is_read:
                prods = d.mul_many(ohv, block)
                acc = prods[0]
                for v in prods[1:]:
                    acc = d.add(acc, v)
                if len(value.lin) == 1 and not value.mul and value.qc == 0:
                    c, w = value.lin[0]
                    if c != 1:
                        raise UnsolvableError("scaled memory read")
                    self.witness[w] = d.norm(acc)
                    return
                raise UnsolvableError("complex memory read expression")
            new = self._eval_expr(value)
            old_prods = d.mul_many(ohv, block)
            old = old_prods[0]
            for v in old_prods[1:]:
                old = d.add(old, v)
            delta = d.sub(new, old)
            upd = d.mul_many(ohv, [delta] * len(block))
            self.memory[block_id] = [d.add(b, u)
                                     for b, u in zip(block, upd)]
            return
        idx = int(idx)
        if is_read:  # value expr is a single unknown witness
            if len(value.lin) == 1 and not value.mul and value.qc == 0:
                c, w = value.lin[0]
                if c != 1:
                    raise UnsolvableError("scaled memory read")
                self.witness[w] = block[idx]
                return
            raise UnsolvableError("complex memory read expression")
        block[idx] = self._eval_expr(value)  # write

    def _op_brillig_call(self, payload):
        """Run an unconstrained hint function (brillig_call_solver.rs):
        evaluate calldata expressions, execute the Brillig VM, scatter the
        return data into the output witnesses. A false predicate zeroes
        the outputs without running."""
        from .brillig import BrilligVM

        fn_id, inputs, outputs, predicate = (
            payload[0], payload[1], payload[2], payload[3])
        d = self.d
        mask = None  # shared predicate: cmux outputs with zero after
        run = True
        if predicate is not None:
            pred = self._eval_expr(Expression.parse(predicate))
            if d.is_shared(pred):
                mask = pred  # brillig_call_solver.rs BrilligMask::Mask
            else:
                run = int(pred) != 0
        out_wits = []
        for o in outputs:
            if isinstance(o, dict) and "Simple" in o:
                out_wits.append(int(o["Simple"]))
            elif isinstance(o, dict) and "Array" in o:
                out_wits.extend(int(w) for w in o["Array"])
            else:
                raise UnsolvableError(f"unhandled brillig output {o!r}")
        if not run:
            for w in out_wits:
                self.witness[w] = 0
            return
        calldata = []
        for inp in inputs:
            if isinstance(inp, dict) and "Single" in inp:
                calldata.append(self._eval_expr(
                    Expression.parse(inp["Single"])))
            elif isinstance(inp, dict) and "Array" in inp:
                calldata.extend(self._eval_expr(Expression.parse(e))
                                for e in inp["Array"])
            elif isinstance(inp, dict) and "MemoryArray" in inp:
                calldata.extend(self.memory[int(inp["MemoryArray"])])
            else:
                raise UnsolvableError(f"unhandled brillig input {inp!r}")
        if self._brillig_vm is None:
            self._brillig_vm = BrilligVM(d, self.p, self.brillig_fns)
        res = self._brillig_vm.run(int(fn_id), calldata)
        if len(res) != len(out_wits):
            raise UnsolvableError(
                f"brillig returned {len(res)} values for {len(out_wits)} "
                "outputs")
        for w, v in zip(out_wits, res):
            if mask is not None:
                v = d.cmux(mask, v, 0)
            self.witness[w] = d.norm(v)

    def _op_call(self, payload):
        raise UnsolvableError("acir Call not wired yet")


def solve_program(artifact, driver, p: int, input_values: list):
    """Solve the main function; returns the witness dict."""
    fn = artifact.functions[0]
    solver = CoSolver(fn, driver, p, brillig_fns=artifact.brillig)
    solver.set_inputs(input_values)
    return solver.solve()


def _shared_complete_add(d, p1, p2):
    """Branchless complete Grumpkin affine add over driver values:
    (x, y, inf) triples, any mix of public ints and shares. Handles
    double / cancel / either-infinity via shared predicates; masked
    slope denominators are nonzero in every selected case (Grumpkin has
    odd prime order, so 2y == 0 only at the infinity placeholder)."""
    x1, y1, i1 = p1
    x2, y2, i2 = p2
    same_x = d.eq(x1, x2)
    same_y = d.eq(y1, y2)
    dbl = d.mul(same_x, same_y)
    cancel = d.mul(same_x, d.sub(1, same_y))
    den_add = d.add(d.sub(x2, x1), same_x)
    den_dbl = d.add(d.add(y1, y1), d.add(i1, i2))
    lam_add = d.div(d.sub(y2, y1), den_add)
    xx = d.mul(x1, x1)
    lam_dbl = d.div(d.add(d.add(xx, xx), xx), den_dbl)
    lam = d.cmux(dbl, lam_dbl, lam_add)
    x3 = d.sub(d.sub(d.mul(lam, lam), x1), x2)
    y3 = d.sub(d.mul(lam, d.sub(x1, x3)), y1)
    rx = d.cmux(cancel, 0, x3)
    ry = d.cmux(cancel, 0, y3)
    ri = cancel
    rx = d.cmux(i2, x1, rx)
    ry = d.cmux(i2, y1, ry)
    ri = d.cmux(i2, i1, ri)
    rx = d.cmux(i1, x2, rx)
    ry = d.cmux(i1, y2, ry)
    ri = d.cmux(i1, i2, ri)
    return rx, ry, ri


def _shared_incomplete_add_many(d, ps, qs):
    """Batched affine adds assuming every pair is finite with distinct
    x (the windowed-MSM offsets make collisions negligible): one batched
    masked inversion + two batched mul rounds for the whole level."""
    dens = [d.to_share(d.sub(q[0], p[0])) for p, q in zip(ps, qs)]
    invs = d.pr.inv_many(dens)
    nums = [d.sub(q[1], p[1]) for p, q in zip(ps, qs)]
    lams = d.mul_many(nums, invs)
    l2 = d.mul_many(lams, lams)
    x3s = [d.sub(d.sub(a, p[0]), q[0])
           for a, p, q in zip(l2, ps, qs)]
    t = d.mul_many(lams, [d.sub(p[0], x3) for p, x3 in zip(ps, x3s)])
    y3s = [d.sub(v, p[1]) for v, p in zip(t, ps)]
    return list(zip(x3s, y3s))


def shared_fixed_base_msm(d, pairs, hc):
    """MSM with PUBLIC base points and SHARED 128-bit scalar limbs
    (reference co-acvm shared multi_scalar_mul): per pair, decompose the
    limbs once (A2B), read each 4-bit window's precomputed multiple
    through the batched OHV-LUT gadget (tables offset by deterministic
    random points so every entry is finite), tree-reduce all window
    terms with batched incomplete adds, and fix the offset sum with one
    complete add at the end. Returns a (x, y, inf) triple of driver
    values. pairs: [(host_affine_point, lo_share, hi_share)]."""
    import hashlib

    from ..mpc.rep3_ring import Rep3Ring, read_public_luts_many
    from ..mpc.rep3_scalar import BShare

    W = 4
    NWIN = 256 // W  # lo and hi give 128 bits each
    fp = d.pr
    ring = Rep3Ring(fp.net, fp.rng, 32)
    p = fp.p

    def rho(tag: bytes) -> int:
        h = hashlib.blake2b(b"cosnarks-msm-offset" + tag,
                            digest_size=32).digest()
        return int.from_bytes(h, "big")

    # bit-decompose all limbs in one batch
    limb_shares = []
    for _, lo, hi in pairs:
        limb_shares += [d.to_share(lo), d.to_share(hi)]
    bits = fp.a2b_many(limb_shares)

    luts, idxs, offsets = [], [], []
    for pi, (base, _lo, _hi) in enumerate(pairs):
        blo, bhi = bits[2 * pi], bits[2 * pi + 1]
        # component high bits XOR to zero (value < 2^128) but are not
        # individually zero: mask them before packing the two limbs
        m128 = (1 << 128) - 1
        sbits = BShare((blo.a & m128) | ((bhi.a & m128) << 128),
                       (blo.b & m128) | ((bhi.b & m128) << 128))
        base_l = hc.lift_affine(base)
        for j in range(NWIN):
            off = hc.mul(hc.generator, rho(b"%d-%d" % (pi, j)))
            offsets.append(off)
            step = hc.mul(base_l, 1 << (W * j))
            xs, ys = [], []
            t = off
            for dd in range(1 << W):
                ax, ay = hc.affine_ints(t)
                xs.append(ax)
                ys.append(ay)
                t = hc.add(t, step)
            luts.append((xs, ys))
            idxs.append(BShare((sbits.a >> (W * j)) & 0xF,
                               (sbits.b >> (W * j)) & 0xF, W))
    terms = [list(t) for t in
             read_public_luts_many(ring, fp, luts, idxs, W)]

    while len(terms) > 1:
        half = len(terms) // 2
        merged = _shared_incomplete_add_many(
            d, terms[:half], terms[half:2 * half])
        rest = terms[2 * half:]
        terms = [list(t) for t in merged] + rest
    acc_x, acc_y = terms[0]

    corr = None
    for off in offsets:
        corr = off if corr is None else hc.add(corr, off)
    cx, cy = hc.affine_ints(hc.neg(corr))
    return _shared_complete_add(d, (acc_x, acc_y, 0), (cx, cy, 0))
