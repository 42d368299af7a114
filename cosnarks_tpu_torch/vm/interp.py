"""Port of `cosnarks_tpu.vm.interp`: host Python, copied unchanged.

circom witness-extension interpreter (plain/cleartext driver).

The role of the reference's circom-mpc-vm (stack VM over MpcOpCode bytecode,
circom-mpc-vm/src/mpc_vm.rs) — re-architected: instead of bytecode we
interpret the AST directly, with component bodies run lazily once all their
inputs are assigned (circom's execution model). The plain driver computes on
python ints; the MPC drivers will plug in at the same `Driver` seam
(mirroring VmCircomWitnessExtension, circom-mpc-vm/src/mpc.rs:14).

Constraint statements (===) are CHECKED during execution — a free sanity
oracle the reference only gets via assert opcodes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..ff.spec import Field
from . import lang


class CircomError(Exception):
    pass


class PlainDriver:
    """Cleartext ops (the reference's plain_vm driver)."""

    def __init__(self, field: Field):
        self.p = field.p
        self.half = field.p >> 1

    def lift(self, x):  # signed representative for comparisons
        return x - self.p if x > self.half else x

    # -- share plumbing (trivial for the plain driver) ----------------------
    def is_shared(self, x) -> bool:
        return False

    def norm(self, x):
        """Canonicalize a value (int/decimal-string mod p)."""
        return int(x) % self.p

    def cmux(self, c, t, f):
        return t if c else f

    def assert_eq(self, l, r, ctx=""):
        if l != r:
            raise CircomError(f"constraint violated{ctx}: {l} != {r}")

    def assert_true(self, c, ctx=""):
        if not self.is_true(c):
            raise CircomError(f"assert failed{ctx}")

    def land(self, a, b):
        return int(self.is_true(a) and self.is_true(b))

    def lor(self, a, b):
        return int(self.is_true(a) or self.is_true(b))

    def lnot(self, a):
        return int(not self.is_true(a))

    def neq(self, a, b):
        return 1 - self.eq(a, b)

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def div(self, a, b):
        if b == 0:
            raise CircomError("division by zero")
        return a * pow(b, -1, self.p) % self.p

    def idiv(self, a, b):
        if b == 0:
            raise CircomError("integer division by zero")
        return a // b

    def mod(self, a, b):
        return a % b

    def pow(self, a, b):
        return pow(a, b, self.p)

    def neg(self, a):
        return (-a) % self.p

    def lt(self, a, b):
        return int(self.lift(a) < self.lift(b))

    def le(self, a, b):
        return int(self.lift(a) <= self.lift(b))

    def eq(self, a, b):
        return int(a == b)

    def band(self, a, b):
        return (a & b) % self.p

    def bor(self, a, b):
        return (a | b) % self.p

    def bxor(self, a, b):
        return (a ^ b) % self.p

    def bnot(self, a):
        mask = (1 << self.p.bit_length()) - 1
        return (a ^ mask) % self.p

    def shl(self, a, k):
        return (a << k) % self.p if k < 512 else 0

    def shr(self, a, k):
        return a >> k if k < 512 else 0

    def is_true(self, a):
        return a != 0

    # -- accelerator ops (reference mpc/plain.rs + accelerator.rs) ----------
    def sqrt(self, a):
        """circomlib-compatible sqrt: the root in [0, p/2], or 0 when no
        root exists (pointbits.circom:27-36 returns 0 on QNR)."""
        from ..mpc.rep3_scalar import _sqrt_mod

        s = _sqrt_mod(a % self.p, self.p)
        if s is None:
            return 0
        return self.p - s if s > self.half else s

    def num2bits(self, a, n):
        return [(a >> i) & 1 for i in range(n)]

    def addbits(self, a_bits, b_bits):
        """MSB-first bitwise add; returns (sum bits MSB-first, carry)."""
        n = len(a_bits)
        va = sum(b << (n - 1 - i) for i, b in enumerate(a_bits))
        vb = sum(b << (n - 1 - i) for i, b in enumerate(b_bits))
        s = va + vb
        return [(s >> (n - 1 - i)) & 1 for i in range(n)], (s >> n) & 1

    def mul_many(self, xs, ys):
        return [self.mul(a, b) for a, b in zip(xs, ys)]

    def flush_asserts(self):
        pass


def _make_storage(dims):
    if not dims:
        return {"_": None}
    return {}


@dataclasses.dataclass
class SignalInfo:
    kind: str
    dims: list  # evaluated int dims
    values: dict  # index tuple -> int (scalar key: ())


class Instance:
    """One instantiated template (component)."""

    def __init__(self, vm, template: lang.Template, args: list):
        self.vm = vm
        self.template = template
        self.params = dict(zip(template.params, args))
        self.vars: list[dict] = [dict(self.params)]
        self.signals: dict[str, SignalInfo] = {}
        self.components: dict[str, Any] = {}  # name -> Instance | dict idx->
        self.comp_dims: dict[str, list] = {}
        self.input_count = 0
        self.inputs_set = 0
        self.executed = False
        self.signal_order: list[str] = []
        # pre-scan declarations to know inputs (they may appear anywhere)
        self._pending = list(template.body)

    # signal helpers
    def decl_signal(self, name, kind, dims):
        self.signals[name] = SignalInfo(kind, dims, {})
        self.signal_order.append(name)
        if kind == "input":
            self.input_count += _count(dims)

    def set_signal(self, name, idx, value):
        info = self.signals[name]
        if idx in info.values:
            raise CircomError(f"signal {name}{idx} assigned twice")
        info.values[idx] = value
        if self.vm._journals:
            self.vm._journals[-1][("sig", id(self), name, idx)] = {
                "inst": self, "new": value,
            }
        if info.kind == "input":
            self.inputs_set += 1
            if self.inputs_set == self.input_count and not self.executed:
                if self.vm._journals:
                    raise CircomError(
                        "component execution triggered inside a shared-"
                        "condition branch (unsupported; hoist the component "
                        "inputs out of the branch)"
                    )
                self.vm.run_instance(self)

    def unset_signal(self, name, idx):
        """Undo helper for shared-branch journaling."""
        info = self.signals[name]
        del info.values[idx]
        if info.kind == "input":
            self.inputs_set -= 1

    def get_signal(self, name, idx):
        info = self.signals[name]
        if idx not in info.values:
            raise CircomError(f"signal {name}{list(idx)} read before assignment")
        return info.values[idx]


def _count(dims):
    n = 1
    for d in dims:
        n *= d
    return n


def _indices(dims):
    if not dims:
        yield ()
        return
    import itertools

    yield from itertools.product(*[range(d) for d in dims])


class _Return(Exception):
    def __init__(self, v):
        self.value = v


class WitnessVM:
    """Runs main with given inputs; collects the full signal assignment."""

    def __init__(self, program: lang.Program, field: Field, driver=None,
                 allow_logs: bool = True, accel=None):
        from .accelerator import MpcAccelerator

        self.prog = program
        self.field = field
        self.d = driver or PlainDriver(field)
        self.accel = accel or MpcAccelerator()
        self.logs: list[str] = []
        self.allow_logs = allow_logs
        self._journals: list[dict] = []  # shared-branch write journals
        # accumulated shared branch conditions (AND of nested shared-if /
        # ternary predicates); guards div-by-untaken-branch and softens
        # asserts, mirroring the reference's IfCtxStack (mpc_vm.rs:96-203,
        # Div opcode at mpc_vm.rs:615-622)
        self._branch_conds: list = []
        self._branch_raw: list = []  # per-level raw (un-ANDed) conditions
        self._fn_ctx: list = []  # per-active-function-call return state

    # -- public API ---------------------------------------------------------
    def run(self, inputs: dict) -> "Instance":
        """inputs: name -> int | nested lists. Returns the main Instance."""
        if self.prog.main is None:
            raise CircomError("no main component")
        call = self.prog.main
        args = [self._const_expr(a) for a in call.args]
        main = self.instantiate(call.name, args)
        self.main = main
        # assign inputs (this triggers execution once complete)
        input_names = [
            n for n in main.signal_order if main.signals[n].kind == "input"
        ]
        flat_mode = False
        if len(inputs) == 1:
            key = next(iter(inputs))
            flat_len = len(_as_flat(inputs[key]))
            total = sum(_count(main.signals[n].dims) for n in input_names)
            if key not in main.signals:
                flat_mode = True
            elif (
                flat_len == total
                and flat_len != _count(main.signals[key].dims)
            ):
                flat_mode = True
        if flat_mode:
            # KAT convention: one flat "in" list feeding all input signals
            # in declaration order
            flat = _as_flat(next(iter(inputs.values())))
            expected = sum(_count(main.signals[n].dims) for n in input_names)
            if len(flat) != expected:
                raise CircomError(
                    f"flat input length {len(flat)} != {expected}"
                )
            pos = 0
            for n in input_names:
                for idx in _indices(main.signals[n].dims):
                    main.set_signal(n, idx, self.d.norm(flat[pos]))
                    pos += 1
        else:
            for name, val in inputs.items():
                if name not in main.signals:
                    raise CircomError(f"unknown input {name}")
                info = main.signals[name]
                flat = _as_flat(val)
                if info.dims and len(flat) == _count(info.dims):
                    # accept flat row-major fill for array inputs
                    for pos, idx in enumerate(_indices(info.dims)):
                        main.set_signal(name, idx, self.d.norm(flat[pos]))
                    continue
                for idx, v in _flatten(val, info.dims, name):
                    main.set_signal(name, idx, self.d.norm(v))
        if not main.executed:
            missing = main.input_count - main.inputs_set
            raise CircomError(f"main not executed: {missing} inputs missing")
        self.d.flush_asserts()  # batched shared `===` checks (one open round)
        return main

    def main_outputs(self, main: "Instance") -> list[int]:
        out = []
        for name in main.signal_order:
            info = main.signals[name]
            if info.kind == "output":
                for idx in _indices(info.dims):
                    out.append(info.values.get(idx, 0))
        return out

    # -- instantiation / execution ------------------------------------------
    def instantiate(self, tname: str, args: list) -> Instance:
        if tname not in self.prog.templates:
            raise CircomError(f"unknown template {tname}")
        inst = Instance(self, self.prog.templates[tname], args)
        # pre-pass: declare signals (they can be referenced before their
        # statement executes only via components; circom declares in order,
        # so we declare lazily during execution EXCEPT inputs, which must be
        # known up front to trigger execution.
        self._predeclare(inst, inst.template.body)
        if inst.input_count == 0:
            self.run_instance(inst)
        return inst

    def _predeclare(self, inst, stmts):
        for s in stmts:
            if isinstance(s, list):
                self._predeclare(inst, s)
            elif isinstance(s, lang.SignalDecl):
                try:
                    dims = [self._eval_in(inst, d) for d in s.dims]
                except CircomError:
                    continue  # dims not param-derivable; declared at exec
                if s.name not in inst.signals:
                    inst.decl_signal(s.name, s.kind, dims)
            elif isinstance(s, (lang.If,)):
                self._predeclare(inst, s.then)
                if s.els:
                    self._predeclare(inst, s.els)
            elif isinstance(s, (lang.For,)):
                self._predeclare(inst, s.body)
            elif isinstance(s, (lang.While,)):
                self._predeclare(inst, s.body)

    def run_instance(self, inst: Instance):
        inst.executed = True
        if self._try_accelerate(inst):
            return
        self._exec_block(inst, inst.template.body)

    # required driver op per accelerated component (skip when driver lacks it)
    _ACCEL_CMP_OPS = {
        "Num2Bits": "num2bits",
        "AddBits": "addbits",
        "IsZero": "eq",
        "Poseidon2": "poseidon2",
    }

    def _try_accelerate(self, inst: Instance) -> bool:
        """Component-level MPC accelerator dispatch (accelerator.rs:124-300):
        when every input is set and at least one is shared, replace the
        template body with one driver-level protocol op whose outputs and
        intermediate signals reproduce the circom trace exactly."""
        name = inst.template.name
        in_names = [n for n in inst.signal_order
                    if inst.signals[n].kind == "input"]
        flat_in = []
        for n in in_names:
            info = inst.signals[n]
            for idx in _indices(info.dims):
                flat_in.append(info.values[idx])
        if not self.accel.has_cmp(name, len(flat_in)):
            return False
        if not any(self.d.is_shared(v) for v in flat_in):
            return False  # plain trace: run the template body as written
        if not hasattr(self.d, self._ACCEL_CMP_OPS.get(name, "")):
            return False
        out_slots = []
        inter_slots = []
        for n in inst.signal_order:
            info = inst.signals[n]
            if info.kind == "output":
                out_slots += [(n, idx) for idx in _indices(info.dims)]
            elif info.kind == "intermediate":
                inter_slots += [(n, idx) for idx in _indices(info.dims)]
        outs, inters = self.accel.run_cmp(name, self.d, flat_in,
                                          len(out_slots))
        if len(outs) != len(out_slots) or len(inters) > len(inter_slots):
            raise CircomError(
                f"accelerator {name}: trace shape mismatch "
                f"({len(outs)}/{len(out_slots)} outputs)"
            )
        for (n, idx), v in zip(out_slots, outs):
            inst.set_signal(n, idx, v)
        for (n, idx), v in zip(inter_slots, inters):
            inst.set_signal(n, idx, v)
        return True

    # -- statement execution -------------------------------------------------
    def _exec_block(self, inst, stmts):
        for s in stmts:
            self._exec(inst, s)

    def _exec(self, inst, s):
        if isinstance(s, list):
            self._exec_block(inst, s)
        elif isinstance(s, lang.SignalDecl):
            if s.name not in inst.signals:  # dims were not param-derivable
                dims = [self._eval_in(inst, d) for d in s.dims]
                inst.decl_signal(s.name, s.kind, dims)
            if s.init is not None:
                v = self._eval_in(inst, s.init)
                inst.set_signal(s.name, (), self.d.norm(v))
        elif isinstance(s, lang.VarDecl):
            dims = [self._eval_in(inst, d) for d in s.dims]
            if dims:
                store = _nested_zeros(dims)
                if s.init is not None:
                    val = self._eval_in(inst, s.init)
                    store = _fit_nested(val, dims)
                inst.vars[-1][s.name] = store
            else:
                inst.vars[-1][s.name] = (
                    self._eval_in(inst, s.init) if s.init is not None else 0
                )
        elif isinstance(s, lang.ComponentDecl):
            dims = [self._eval_in(inst, d) for d in s.dims]
            inst.comp_dims[s.name] = dims
            if dims:
                inst.components.setdefault(s.name, {})
            if s.init is not None:
                call = s.init
                args = [self._eval_in(inst, a) for a in call.args]
                inst.components[s.name] = self.instantiate(call.name, args)
        elif isinstance(s, lang.Assign):
            self._exec_assign(inst, s)
        elif isinstance(s, lang.ConstraintEq):
            l = self._eval_in(inst, s.l)
            r = self._eval_in(inst, s.r)
            self._assert_eq(l, r, f" in {inst.template.name}")
        elif isinstance(s, lang.If):
            cond = self._eval_in(inst, s.cond)
            if self.d.is_shared(cond):
                self._exec_shared_if(inst, s, cond)
            elif self.d.is_true(cond):
                self._exec_scoped(inst, s.then)
            elif s.els:
                self._exec_scoped(inst, s.els)
        elif isinstance(s, lang.For):
            inst.vars.append({})
            try:
                self._exec(inst, s.init)
                while self.d.is_true(self._eval_in(inst, s.cond)):
                    self._exec_scoped(inst, s.body)
                    self._exec(inst, s.step)
            finally:
                inst.vars.pop()
        elif isinstance(s, lang.While):
            while self.d.is_true(self._eval_in(inst, s.cond)):
                self._exec_scoped(inst, s.body)
        elif isinstance(s, lang.Assert):
            c = self._eval_in(inst, s.cond)
            guard = self._live_guard()
            if guard is not None:
                # assert only where live: guard * is_zero(c) must be 0
                z = self.d.eq(c, 0)
                self.d.assert_eq(
                    self.d.mul(guard, z), 0, f" in {inst.template.name}"
                )
            else:
                self.d.assert_true(c, f" in {inst.template.name}")
        elif isinstance(s, lang.Log):
            if self.allow_logs:
                parts = []
                for a in s.args:
                    parts.append(
                        a if isinstance(a, str) else str(self._eval_in(inst, a))
                    )
                self.logs.append(" ".join(parts))
        elif isinstance(s, lang.Return):
            v = self._eval_in(inst, s.value)
            ctx = self._fn_ctx[-1] if self._fn_ctx else None
            if ctx is not None and len(self._branch_conds) > ctx["depth"]:
                # predicated return inside a shared-condition branch of this
                # function: first-return-wins multiplexing (the reference VM
                # predicates ReturnFn the same way, mpc_vm.rs:312 if-ctx).
                # Statements after a predicated return in the SAME branch
                # still execute (their writes only feed the not-returned
                # path via the final multiplex).
                raws = self._branch_raw[ctx["depth"]:]
                local = raws[0]
                for r in raws[1:]:
                    local = self.d.land(local, r)
                if ctx["returned"] is None:
                    eff = local
                    prior = _zeros_shaped(v)
                    ctx["returned"] = local
                else:
                    eff = self.d.land(local, self.d.lnot(ctx["returned"]))
                    prior = ctx["retval"]
                    ctx["returned"] = self.d.lor(ctx["returned"], local)
                ctx["retval"] = self._cmux_value(eff, v, prior)
            else:
                raise _Return(v)
        else:
            raise CircomError(f"unhandled statement {s}")

    def _live_guard(self):
        """Combined liveness predicate: shared branch condition AND
        not-yet-returned (for predicated function returns). None = fully
        live (plain execution)."""
        g = None
        if self._branch_conds:
            g = self._branch_conds[-1]
        ctx = self._fn_ctx[-1] if self._fn_ctx else None
        if ctx is not None and ctx["returned"] is not None:
            nr = self.d.lnot(ctx["returned"])
            g = nr if g is None else self.d.land(g, nr)
        return g

    def _assert_eq(self, l, r, ctx):
        """Elementwise `===` (arrays recurse); inside a shared branch the
        constraint applies only where the branch is taken, so assert
        cond * (l - r) == 0 instead."""
        if isinstance(l, list) or isinstance(r, list):
            if (not isinstance(l, list) or not isinstance(r, list)
                    or len(l) != len(r)):
                raise CircomError(f"constraint dimension mismatch{ctx}")
            for a, b in zip(l, r):
                self._assert_eq(a, b, ctx)
            return
        if self._branch_conds:
            diff = self.d.mul(self._branch_conds[-1], self.d.sub(l, r))
            self.d.assert_eq(diff, 0, ctx)
        else:
            self.d.assert_eq(l, r, ctx)

    def _exec_scoped(self, inst, stmts):
        inst.vars.append({})
        try:
            self._exec_block(inst, stmts)
        finally:
            inst.vars.pop()

    # -- shared-condition branching -----------------------------------------
    # Mirrors the reference VM's if-handling on shared predicates
    # (circom-mpc-vm/src/mpc_vm.rs:312): execute BOTH branches, journal every
    # write, undo, then commit cmux(cond, then_value, else_value) per
    # location. Writes present in only one branch multiplex against the
    # prior value (vars) or public 0 (previously-unset signals).

    def _run_journaled(self, inst, stmts) -> dict:
        self._journals.append({})
        try:
            self._exec_scoped(inst, stmts)
        finally:
            journal = self._journals.pop()
            for key, entry in reversed(list(journal.items())):
                if key[0] == "sig":
                    entry["inst"].unset_signal(key[2], key[3])
                else:
                    holder, idx = entry["holder"], key[3]
                    if not idx:
                        holder[key[2]] = entry["old"]
                    else:
                        v = holder[key[2]]
                        for i in idx[:-1]:
                            v = v[i]
                        v[idx[-1]] = entry["old"]
        return journal

    def _cmux_value(self, cond, t, f):
        if isinstance(t, list) or isinstance(f, list):
            if not isinstance(t, list) or not isinstance(f, list) or \
                    len(t) != len(f):
                raise CircomError(
                    "shared-condition branches assign incompatible arrays"
                )
            return [self._cmux_value(cond, a, b) for a, b in zip(t, f)]
        return self.d.cmux(cond, t, f)

    def _push_branch(self, cond, truthy: bool):
        """Push the accumulated shared condition for one branch (the
        reference's IfCtxStack::push_shared / toggle, mpc_vm.rs:160-203)."""
        raw = cond if truthy else self.d.lnot(cond)
        c = raw
        if self._branch_conds:
            c = self.d.land(self._branch_conds[-1], c)
        self._branch_conds.append(c)
        self._branch_raw.append(raw)

    def _pop_branch(self):
        self._branch_conds.pop()
        self._branch_raw.pop()

    def _exec_shared_if(self, inst, s, cond):
        self._push_branch(cond, True)
        try:
            j_then = self._run_journaled(inst, s.then)
        finally:
            self._pop_branch()
        self._push_branch(cond, False)
        try:
            j_else = self._run_journaled(inst, s.els or [])
        finally:
            self._pop_branch()
        keys = list(j_then) + [k for k in j_else if k not in j_then]
        for key in keys:
            et, ee = j_then.get(key), j_else.get(key)
            if key[0] == "sig":
                holder = (et or ee)["inst"]
                prior = 0  # previously unset (double-assign raised otherwise)
                vt = et["new"] if et else prior
                vf = ee["new"] if ee else prior
                holder.set_signal(key[2], key[3], self._cmux_value(cond, vt, vf))
            else:
                entry = et or ee
                holder, idx = entry["holder"], key[3]
                vt = et["new"] if et else entry["old"]
                vf = ee["new"] if ee else entry["old"]
                merged = self._cmux_value(cond, vt, vf)
                if not idx:
                    holder[key[2]] = merged
                else:
                    v = holder[key[2]]
                    for i in idx[:-1]:
                        v = v[i]
                    v[idx[-1]] = merged

    def _exec_assign(self, inst, s: lang.Assign):
        if s.op == "expr":
            self._eval_in(inst, s.value)
            return
        tgt = s.target
        if s.op in ("++", "--"):
            cur = self._read_target(inst, tgt)
            v = self.d.add(cur, 1) if s.op == "++" else self.d.sub(cur, 1)
            self._write_target(inst, tgt, v, "=")
            return
        # component instantiation: comp[i] = Tpl(args)
        if (
            s.op == "="
            and isinstance(s.value, lang.Call)
            and s.value.name in self.prog.templates
        ):
            name = tgt.base
            idx = tuple(self._eval_in(inst, e) for _, e in tgt.path)
            args = [self._eval_in(inst, a) for a in s.value.args]
            child = self.instantiate(s.value.name, args)
            if idx:
                inst.components.setdefault(name, {})[idx] = child
            else:
                inst.components[name] = child
            return
        val = self._eval_in(inst, s.value)
        if s.op in ("+=", "-=", "*=", "/=", "\\=", "%=", "**=", "<<=", ">>=",
                    "&=", "|=", "^="):
            cur = self._read_target(inst, tgt)
            val = self._apply_bin(s.op[:-1], cur, val)
            self._write_target(inst, tgt, val, "=")
            return
        self._write_target(inst, tgt, val, s.op)

    # -- lvalue resolution ---------------------------------------------------
    def _resolve(self, inst, acc: lang.Access):
        """Returns ("var", scope, name, idx) | ("sig", inst2, name, idx)."""
        name = acc.base
        # component access: comp(.[i])*.sig[j]...
        if name in inst.components or name in inst.comp_dims:
            i = 0
            idx = []
            while i < len(acc.path) and acc.path[i][0] == "idx":
                idx.append(self._eval_in(inst, acc.path[i][1]))
                i += 1
            comp = inst.components.get(name)
            if isinstance(comp, dict):
                comp = comp.get(tuple(idx))
                if comp is None:
                    raise CircomError(f"component {name}{idx} not instantiated")
            if i < len(acc.path) and acc.path[i][0] == "field":
                signame = acc.path[i][1]
                i += 1
                sidx = tuple(
                    self._eval_in(inst, e) for kind, e in acc.path[i:]
                )
                return ("sig", comp, signame, sidx)
            return ("comp", comp, None, ())
        if name in inst.signals:
            sidx = tuple(self._eval_in(inst, e) for _, e in acc.path)
            return ("sig", inst, name, sidx)
        # variable
        for scope in reversed(inst.vars):
            if name in scope:
                idx = tuple(self._eval_in(inst, e) for _, e in acc.path)
                return ("var", scope, name, idx)
        raise CircomError(f"unknown identifier {name} in {inst.template.name}")

    def _read_target(self, inst, acc):
        kind, holder, name, idx = self._resolve(inst, acc)
        if kind == "sig":
            info = holder.signals[name]
            if len(idx) < len(info.dims):
                # bulk read: nested list over the remaining dimensions
                rem = info.dims[len(idx):]

                def rec(prefix, dims):
                    if not dims:
                        return holder.get_signal(name, tuple(prefix))
                    return [rec(prefix + [i], dims[1:]) for i in range(dims[0])]

                return rec(list(idx), rem)
            return holder.get_signal(name, idx)
        if kind == "var":
            v = holder[name]
            for i in idx:
                v = v[i]
            return v
        raise CircomError("cannot read component")

    def _write_target(self, inst, acc, val, op):
        kind, holder, name, idx = self._resolve(inst, acc)
        if kind == "sig":
            info = holder.signals[name]
            if len(idx) < len(info.dims):
                # bulk assignment of (possibly nested) array value
                rem = info.dims[len(idx):]
                flat = _as_flat(val)
                if len(flat) != _count(rem):
                    raise CircomError(
                        f"bulk assign to {name}: {len(flat)} values for "
                        f"{_count(rem)} slots"
                    )
                for pos, sub in enumerate(_indices(rem)):
                    holder.set_signal(name, idx + sub, self.d.norm(flat[pos]))
                return
            holder.set_signal(name, idx, self.d.norm(val))
            return
        if kind == "var":
            if self._journals:
                key = ("var", id(holder), name, idx)
                j = self._journals[-1]
                if key not in j:
                    old = holder.get(name)
                    if idx:
                        for i in idx:
                            old = old[i]
                    j[key] = {"holder": holder, "old": old, "new": val}
                else:
                    j[key]["new"] = val
            if not idx:
                holder[name] = val
            else:
                v = holder[name]
                for i in idx[:-1]:
                    v = v[i]
                v[idx[-1]] = val
            return
        # component assignment: comp[i] = Tpl(args) handled via Assign with
        # Call value
        if kind == "comp":
            raise CircomError("component reassignment unsupported here")

    # -- expression evaluation ----------------------------------------------
    def _const_expr(self, e):
        return self._eval(e, None)

    def _eval_in(self, inst, e):
        return self._eval(e, inst)

    def _eval(self, e, inst):
        d = self.d
        if isinstance(e, lang.Num):
            return e.v % d.p
        if isinstance(e, lang.Ident):
            return self._read_target(inst, lang.Access(e.name, []))
        if isinstance(e, lang.Access):
            return self._read_target(inst, e)
        if isinstance(e, lang.Bin):
            l = self._eval(e.l, inst)
            r = self._eval(e.r, inst)
            return self._apply_bin(e.op, l, r)
        if isinstance(e, lang.Un):
            v = self._eval(e.e, inst)
            if e.op == "-":
                return d.neg(v)
            if e.op == "!":
                return d.lnot(v)
            if e.op == "~":
                return d.bnot(v)
        if isinstance(e, lang.Tern):
            c = self._eval(e.c, inst)
            if d.is_shared(c):
                # shared condition: evaluate both arms under their branch
                # conditions, multiplex (mpc_vm.rs:312; the branch-cond stack
                # guards divisions inside the untaken arm)
                self._push_branch(c, True)
                try:
                    t = self._eval(e.t, inst)
                finally:
                    self._pop_branch()
                self._push_branch(c, False)
                try:
                    f = self._eval(e.f, inst)
                finally:
                    self._pop_branch()
                return d.cmux(c, t, f)
            return (
                self._eval(e.t, inst)
                if d.is_true(c)
                else self._eval(e.f, inst)
            )
        if isinstance(e, lang.ArrayLit):
            return [self._eval(x, inst) for x in e.items]
        if isinstance(e, lang.Call):
            return self._call_function(e, inst)
        raise CircomError(f"unhandled expression {e}")

    def _apply_bin(self, op, l, r):
        d = self.d
        if op == "+":
            return d.add(l, r)
        if op == "-":
            return d.sub(l, r)
        if op == "*":
            return d.mul(l, r)
        if op in ("/", "\\", "%") and self._branch_conds and (
            d.is_shared(r) or d.norm(r) == 0
        ):
            # inside a shared branch the untaken side may divide by zero;
            # the reference guards the divisor with cmux(cond, rhs, 1)
            # (mpc_vm.rs Div opcode, :615-622). Public nonzero divisors
            # need no guard.
            r = d.cmux(self._branch_conds[-1], r, 1)
        if op == "/":
            return d.div(l, r)
        if op == "\\":
            return d.idiv(l, r)
        if op == "%":
            return d.mod(l, r)
        if op == "**":
            return d.pow(l, r)
        if op == "<":
            return d.lt(l, r)
        if op == ">":
            return d.lt(r, l)
        if op == "<=":
            return d.le(l, r)
        if op == ">=":
            return d.le(r, l)
        if op == "==":
            return d.eq(l, r)
        if op == "!=":
            return d.neq(l, r)
        if op == "&&":
            return d.land(l, r)
        if op == "||":
            return d.lor(l, r)
        if op == "&":
            return d.band(l, r)
        if op == "|":
            return d.bor(l, r)
        if op == "^":
            return d.bxor(l, r)
        if op == "<<":
            return d.shl(l, r)
        if op == ">>":
            return d.shr(l, r)
        raise CircomError(f"unhandled operator {op}")

    def _call_function(self, call: lang.Call, inst):
        if call.name not in self.prog.functions:
            raise CircomError(f"unknown function {call.name}")
        fn = self.prog.functions[call.name]
        args = [self._eval(a, inst) for a in call.args]
        if (self.accel.has_fn(call.name)
                and any(self.d.is_shared(a) for a in args)):
            # function-level accelerator (accelerator.rs:133-171): functions
            # produce no witness signals, so replacement is always trace-safe
            return self.accel.run_fn(call.name, self.d, args)
        finst = Instance(self, lang.Template(call.name, fn.params, fn.body),
                         args)
        finst.executed = True
        ctx = {"depth": len(self._branch_conds), "returned": None,
               "retval": None}
        self._fn_ctx.append(ctx)
        try:
            self._exec_block(finst, fn.body)
        except _Return as r:
            # merge any predicated (shared-branch) returns: first-wins
            if ctx["returned"] is not None:
                return self._cmux_value(ctx["returned"], ctx["retval"],
                                        r.value)
            return r.value
        finally:
            self._fn_ctx.pop()
        if ctx["returned"] is not None:
            # control fell off the end but every path through the shared
            # branches returned (circom rejects incomplete coverage)
            return ctx["retval"]
        raise CircomError(f"function {call.name} did not return")


def _zeros_shaped(v):
    """Structural zero matching a return value (scalar or nested lists)."""
    if isinstance(v, list):
        return [_zeros_shaped(x) for x in v]
    return 0


def _as_flat(v):
    if not isinstance(v, (list, tuple)):
        return [v]
    out = []
    for x in v:
        out.extend(_as_flat(x))
    return out


def _flatten(val, dims, name):
    """Nested input value -> [(index tuple, int)] validated against dims."""
    out = []

    def rec(v, idx, depth):
        if depth == len(dims):
            if isinstance(v, (list, tuple)):
                if len(v) == 1:  # snarkjs-style 1-element wrapper
                    v = v[0]
                else:
                    raise CircomError(f"input {name}: too many dimensions")
            out.append((tuple(idx), v))
            return
        if not isinstance(v, (list, tuple)) or len(v) != dims[depth]:
            raise CircomError(f"input {name}: expected {dims[depth]} entries")
        for i, x in enumerate(v):
            rec(x, idx + [i], depth + 1)

    rec(val, [], 0)
    return out


def _nested_zeros(dims):
    if len(dims) == 1:
        return [0] * dims[0]
    return [_nested_zeros(dims[1:]) for _ in range(dims[0])]


def _fit_nested(val, dims):
    return val  # arrays from function returns are already nested lists
