"""Port of `cosnarks_tpu.noir.brillig`: host Python, copied unchanged.

co-Brillig: the unconstrained-function VM, generic over the
witness-extension driver seam.

Counterpart of the reference's CoBrilligVM
(co-noir/co-brillig/src/brillig_vm.rs:75): typed memory (Field /
Integer(bits)), stack-pointer-relative addressing (slot 0 holds the stack
pointer, memory.rs:43-57), calldata copy, call/return, and
fork-the-universe execution for a JumpIf on a SHARED condition (both
universes run to completion, results multiplexed; forward jumps only,
one live shared-if — brillig_vm.rs:261-330).

Integer ops run on arithmetic shares with explicit 2^k wrap via the lazy
binary domain (the reference uses rep3_ring Z_2^k shares); unsigned
comparisons bypass the circom signed-shift semantics.
"""

from __future__ import annotations

from .acir import _fe


class BrilligError(Exception):
    pass


_BITS = {"U0": 0, "U1": 1, "U8": 8, "U16": 16, "U32": 32, "U64": 64,
         "U128": 128}


def _bitsize(t) -> int | None:
    """None = Field, else integer bit width."""
    if t == "Field" or (isinstance(t, dict) and "Field" in str(t)):
        return None
    if isinstance(t, dict):
        (_, v), = t.items()
        return _BITS[v]
    return _BITS[t]


class BrilligVM:
    def __init__(self, driver, p: int, functions: list):
        self.d = driver
        self.p = p
        self.fns = functions  # raw msgpack [(name, [opcodes])]
        self._forked = False

    # -- entry ---------------------------------------------------------------
    def run(self, fn_id: int, calldata: list):
        """calldata: list of driver values (field-typed). Returns the
        return-data list (driver values)."""
        opcodes = self.fns[fn_id][1]
        mem: dict[int, tuple] = {}
        return self._run(opcodes, dict(mem), list(calldata), 0, [])

    # -- helpers --------------------------------------------------------------
    def _resolve(self, mem, addr) -> int:
        if isinstance(addr, dict):
            (kind, off), = addr.items()
            if kind == "Direct":
                return int(off)
            if kind == "Relative":
                sp = self._pub(mem.get(0, (32, 0))[1])
                return int(sp) + int(off)
        raise BrilligError(f"bad address {addr!r}")

    def _pub(self, v) -> int:
        if self.d.is_shared(v):
            raise BrilligError("shared value used as address/size")
        return int(v)

    def _read(self, mem, addr):
        return mem.get(self._resolve(mem, addr), (None, 0))

    def _write(self, mem, addr, tagval):
        mem[self._resolve(mem, addr)] = tagval

    def _wrap(self, v, bits: int):
        """Wrap a driver value to bits (2^k) — free on public ints, one
        lazy-binary mask on shares when it might exceed the width."""
        if bits is None:
            return v
        if not self.d.is_shared(v):
            return int(v) & ((1 << bits) - 1)
        return self.d.mod(v, 1 << bits)

    # -- main loop ------------------------------------------------------------
    def _run(self, ops, mem, calldata, ip, callstack):
        d = self.d
        while True:
            op = ops[ip]
            if op == "Return":
                ip = callstack.pop()
                continue
            (kind, a), = op.items()
            if kind == "Const":
                dest, typ, val = a
                self._write(mem, dest, (_bitsize(typ), _fe(val)))
            elif kind == "IndirectConst":
                ptr, typ, val = a
                loc = self._pub(self._read(mem, ptr)[1])
                mem[int(loc)] = (_bitsize(typ), _fe(val))
            elif kind == "CalldataCopy":
                dest, size_a, off_a = a
                size = self._pub(self._read(mem, size_a)[1])
                off = self._pub(self._read(mem, off_a)[1])
                base = self._resolve(mem, dest)
                for i in range(int(size)):
                    mem[base + i] = (None, calldata[int(off) + i])
            elif kind == "Mov":
                dest, src = a
                self._write(mem, dest, self._read(mem, src))
            elif kind == "Cast":
                dest, src, typ = a
                bits = _bitsize(typ)
                tag, v = self._read(mem, src)
                if bits is not None and (tag is None or tag > bits):
                    v = self._wrap(v, bits)
                self._write(mem, dest, (bits, v))
            elif kind == "Load":
                dest, src_ptr = a
                loc = self._pub(self._read(mem, src_ptr)[1])
                self._write(mem, dest, mem.get(int(loc), (None, 0)))
            elif kind == "Store":
                dest_ptr, src = a
                loc = self._pub(self._read(mem, dest_ptr)[1])
                mem[int(loc)] = self._read(mem, src)
            elif kind == "Jump":
                ip = int(a[0])
                continue
            elif kind == "JumpIf":
                cond_a, loc = a
                cond = self._read(mem, cond_a)[1]
                if d.is_shared(cond):
                    return self._fork(ops, mem, calldata, ip, callstack,
                                      cond_a, int(loc))
                if int(cond):
                    ip = int(loc)
                    continue
            elif kind == "Call":
                callstack.append(ip + 1)
                ip = int(a[0])
                continue
            elif kind == "Stop":
                (ptr_a, size_a), = a
                size = self._pub(self._read(mem, size_a)[1])
                base = self._pub(self._read(mem, ptr_a)[1])
                return [mem.get(int(base) + i, (None, 0))[1]
                        for i in range(int(size))]
            elif kind == "Trap":
                raise BrilligError("brillig trap (assertion in "
                                   "unconstrained fn)")
            elif kind == "Not":
                dest, src, typ = a
                bits = _bitsize(typ)
                tag, v = self._read(mem, src)
                mask = (1 << bits) - 1
                if d.is_shared(v):
                    res = d.sub(mask, v)  # v < 2^bits: NOT = mask - v
                else:
                    res = (~int(v)) & mask
                self._write(mem, dest, (bits, res))
            elif kind == "BinaryFieldOp":
                dest, bop, lhs, rhs = a
                x = self._read(mem, lhs)[1]
                y = self._read(mem, rhs)[1]
                self._write(mem, dest, self._field_op(bop, x, y))
            elif kind == "BinaryIntOp":
                dest, bop, typ, lhs, rhs = a
                bits = _BITS[typ]
                x = self._read(mem, lhs)[1]
                y = self._read(mem, rhs)[1]
                self._write(mem, dest, self._int_op(bop, bits, x, y))
            elif kind == "BlackBox":
                self._blackbox(mem, a)
            else:
                raise BrilligError(f"unhandled brillig opcode {kind}")
            ip += 1

    # -- ops -------------------------------------------------------------------
    def _field_op(self, bop, x, y):
        d = self.d
        if bop == "Add":
            return (None, d.add(x, y))
        if bop == "Sub":
            return (None, d.sub(x, y))
        if bop == "Mul":
            return (None, d.mul(x, y))
        if bop == "Div":
            try:
                return (None, d.div(x, y))
            except ZeroDivisionError:
                # zero shared divisor inside a masked/forked universe: the
                # result is multiplexed away — emit filler (reference
                # substitutes noise, brillig_vm.rs:306-325)
                return (None, 0)
        if bop == "IntegerDiv":
            if d.is_shared(x) or d.is_shared(y):
                return (None, d.idiv(x, y))
            return (None, int(x) // int(y))
        if bop == "Equals":
            return (1, d.eq(x, y))
        if bop == "LessThan":
            return (1, self._ult(x, y))
        if bop == "LessThanEquals":
            return (1, self._ule(x, y))
        raise BrilligError(f"unhandled field op {bop}")

    def _int_op(self, bop, bits, x, y):
        d = self.d
        if bop == "Add":
            return (bits, self._wrap(d.add(x, y), bits))
        if bop == "Sub":
            return (bits, self._wrap(d.add(d.sub(x, y), 1 << bits), bits))
        if bop == "Mul":
            return (bits, self._wrap(d.mul(x, y), bits))
        if bop == "Div":
            if d.is_shared(x) or d.is_shared(y):
                return (bits, d.idiv(x, y))
            return (bits, int(x) // int(y))
        if bop == "Equals":
            return (1, d.eq(x, y))
        if bop == "LessThan":
            return (1, self._ult(x, y))
        if bop == "LessThanEquals":
            return (1, self._ule(x, y))
        if bop == "And":
            return (bits, d.band(x, y))
        if bop == "Or":
            return (bits, d.bor(x, y))
        if bop == "Xor":
            return (bits, d.bxor(x, y))
        if bop == "Shl":
            return (bits, self._wrap(d.shl(x, self._pub(y)), bits))
        if bop == "Shr":
            return (bits, d.shr(x, self._pub(y)))
        raise BrilligError(f"unhandled int op {bop}")

    def _ult(self, x, y):
        """Unsigned less-than on raw values (no circom signed shift)."""
        d = self.d
        if not d.is_shared(x) and not d.is_shared(y):
            return int(int(x) < int(y))
        pr = d.pr
        xs, ys = d.to_share(x), d.to_share(y)
        return pr.lt(xs, ys)

    def _ule(self, x, y):
        d = self.d
        if not d.is_shared(x) and not d.is_shared(y):
            return int(int(x) <= int(y))
        pr = d.pr
        return pr.le(d.to_share(x), d.to_share(y))

    # -- blackboxes -------------------------------------------------------------
    def _blackbox(self, mem, a):
        (name, args), = a.items()
        if name != "ToRadix":
            raise BrilligError(f"unhandled brillig blackbox {name}")
        in_a, radix_a, out_ptr_a, limbs_a, bits_a = args
        d = self.d
        value = self._read(mem, in_a)[1]
        radix = self._pub(self._read(mem, radix_a)[1])
        out_base = self._pub(self._read(mem, out_ptr_a)[1])
        num_limbs = self._pub(self._read(mem, limbs_a)[1])
        as_bits = bool(self._pub(self._read(mem, bits_a)[1]))
        limb_bits = 1 if as_bits else 8
        if radix & (radix - 1) == 0 and radix > 1:
            k = radix.bit_length() - 1
            limbs = []
            cur = value
            for _ in range(int(num_limbs)):
                limbs.append(d.mod(cur, radix) if d.is_shared(cur)
                             else int(cur) % radix)
                cur = d.shr(cur, k) if d.is_shared(cur) else int(cur) >> k
        else:
            if d.is_shared(value):
                raise BrilligError(
                    "shared ToRadix with non-power-of-2 radix unsupported")
            limbs = []
            cur = int(value)
            for _ in range(int(num_limbs)):
                limbs.append(cur % radix)
                cur //= radix
        # most-significant limb first (acvm to_radix reverses)
        for i, limb in enumerate(reversed(limbs)):
            mem[int(out_base) + i] = (limb_bits, limb)

    # -- shared-condition fork (brillig_vm.rs:261-330) ---------------------------
    def _fork(self, ops, mem, calldata, ip, callstack, cond_a, loc):
        if self._forked:
            raise BrilligError("nested shared if in brillig unsupported")
        if loc <= ip:
            raise BrilligError("backward jump on shared condition")
        d = self.d
        cond = self._read(mem, cond_a)[1]
        self._forked = True
        try:
            mem_t = dict(mem)
            self._write(mem_t, cond_a, (1, 1))
            try:
                res_t = self._run(ops, mem_t, list(calldata), loc,
                                  list(callstack))
            except BrilligError:
                res_t = None
            mem_f = dict(mem)
            self._write(mem_f, cond_a, (1, 0))
            try:
                res_f = self._run(ops, mem_f, list(calldata), ip + 1,
                                  list(callstack))
            except BrilligError:
                res_f = None
        finally:
            self._forked = False
        # a universe that trapped is replaced by filler — its values are
        # multiplexed away (the reference substitutes random noise,
        # brillig_vm.rs:306-325)
        if res_t is None and res_f is None:
            raise BrilligError("both shared-if universes trapped")
        if res_t is None:
            res_t = [0] * len(res_f)
        if res_f is None:
            res_f = [0] * len(res_t)
        if len(res_t) != len(res_f):
            raise BrilligError("shared-if universes returned different "
                               "result shapes")
        return [d.cmux(cond, t, f) for t, f in zip(res_t, res_f)]
