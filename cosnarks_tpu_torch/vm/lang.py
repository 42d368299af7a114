"""Port of `cosnarks_tpu.vm.lang`: host Python, copied unchanged.

circom 2.x frontend: lexer + recursive-descent parser -> AST.

Replaces the reference's use of the TaceoLabs circom compiler fork
(co-circom/circom-mpc-compiler/src/lib.rs parses .circom via 5 external GPL
crates). This is an independent implementation of the published circom
language (templates, functions, signals/vars/components, control flow,
the full expression grammar) sufficient for circomlib-style circuits.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

KEYWORDS = {
    "pragma", "circom", "include", "template", "function", "signal", "var",
    "component", "input", "output", "public", "if", "else", "for", "while",
    "do", "return", "assert", "log", "main", "parallel", "custom",
}

TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>0x[0-9a-fA-F]+|\d+)
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>"[^"]*")
  | (?P<op><==|==>|<--|-->|===|<=|>=|==|!=|&&|\|\||<<=|>>=|<<|>>|\+\+|--|\+=|-=|\*\*=|\*=|/=|\\=|%=|&=|\|=|\^=|\*\*|[-+*/\\%&|^~!<>=?:;,.(){}\[\]])
    """,
    re.VERBOSE | re.DOTALL,
)


def tokenize(src: str):
    out = []
    pos = 0
    line = 1
    while pos < len(src):
        m = TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"lex error at line {line}: {src[pos:pos+40]!r}")
        text = m.group(0)
        line += text.count("\n")
        if m.lastgroup != "ws":
            out.append((m.lastgroup, text, line))
        pos = m.end()
    out.append(("eof", "", line))
    return out


# -- AST --------------------------------------------------------------------

@dataclasses.dataclass
class Num:
    v: int


@dataclasses.dataclass
class Ident:
    name: str


@dataclasses.dataclass
class Access:
    """base . field? [idx]* chains, e.g. comp[i].out[j]"""

    base: str
    path: list  # items: ("idx", expr) | ("field", name)


@dataclasses.dataclass
class Bin:
    op: str
    l: Any
    r: Any


@dataclasses.dataclass
class Un:
    op: str
    e: Any


@dataclasses.dataclass
class Tern:
    c: Any
    t: Any
    f: Any


@dataclasses.dataclass
class Call:
    name: str
    args: list


@dataclasses.dataclass
class ArrayLit:
    items: list


@dataclasses.dataclass
class SignalDecl:
    name: str
    kind: str  # "input" | "output" | "intermediate"
    dims: list
    init: Any = None
    init_op: str | None = None
    tags: tuple = ()


@dataclasses.dataclass
class VarDecl:
    name: str
    dims: list
    init: Any = None


@dataclasses.dataclass
class ComponentDecl:
    name: str
    dims: list
    init: Any = None


@dataclasses.dataclass
class Assign:
    op: str  # '=', '<==', '<--', '+=', ... '++', '--'
    target: Access
    value: Any = None


@dataclasses.dataclass
class ConstraintEq:
    l: Any
    r: Any


@dataclasses.dataclass
class If:
    cond: Any
    then: list
    els: list | None


@dataclasses.dataclass
class For:
    init: Any
    cond: Any
    step: Any
    body: list


@dataclasses.dataclass
class While:
    cond: Any
    body: list


@dataclasses.dataclass
class Return:
    value: Any


@dataclasses.dataclass
class Assert:
    cond: Any


@dataclasses.dataclass
class Log:
    args: list


@dataclasses.dataclass
class Template:
    name: str
    params: list
    body: list
    parallel: bool = False


@dataclasses.dataclass
class Function:
    name: str
    params: list
    body: list


@dataclasses.dataclass
class Program:
    templates: dict
    functions: dict
    main: Call | None
    main_public: list


class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text):
        t = self.next()
        if t[1] != text:
            raise SyntaxError(f"line {t[2]}: expected {text!r}, got {t[1]!r}")
        return t

    def accept(self, text):
        if self.peek()[1] == text:
            self.next()
            return True
        return False

    # -- top level ----------------------------------------------------------
    def parse_program(self):
        templates, functions = {}, {}
        main = None
        main_public = []
        includes = []
        while self.peek()[0] != "eof":
            t = self.peek()
            if t[1] == "pragma":
                while self.next()[1] != ";":
                    pass
            elif t[1] == "include":
                self.next()
                includes.append(self.next()[1].strip('"'))
                self.expect(";")
            elif t[1] == "template":
                tpl = self.parse_template()
                templates[tpl.name] = tpl
            elif t[1] == "function":
                fn = self.parse_function()
                functions[fn.name] = fn
            elif t[1] == "component":
                # component main {public [a,b]} = Tpl(...);
                self.next()
                self.expect("main")
                if self.accept("{"):
                    self.expect("public")
                    self.expect("[")
                    while True:
                        main_public.append(self.next()[1])
                        if not self.accept(","):
                            break
                    self.expect("]")
                    self.expect("}")
                self.expect("=")
                main = self.parse_expr()
                self.expect(";")
            else:
                raise SyntaxError(f"line {t[2]}: unexpected {t[1]!r}")
        prog = Program(templates, functions, main, main_public)
        prog.includes = includes
        return prog

    def parse_template(self):
        self.expect("template")
        parallel = self.accept("parallel")
        self.accept("custom")
        name = self.next()[1]
        params = self.parse_params()
        body = self.parse_block()
        return Template(name, params, body, parallel)

    def parse_function(self):
        self.expect("function")
        name = self.next()[1]
        params = self.parse_params()
        body = self.parse_block()
        return Function(name, params, body)

    def parse_params(self):
        self.expect("(")
        params = []
        if not self.accept(")"):
            while True:
                params.append(self.next()[1])
                if not self.accept(","):
                    break
            self.expect(")")
        return params

    def parse_block(self):
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.parse_stmt())
        return stmts

    # -- statements ---------------------------------------------------------
    def parse_stmt(self):
        t = self.peek()
        if t[1] == "{":
            return self.parse_block()
        if t[1] == "signal":
            return self.parse_signal_decl()
        if t[1] == "var":
            return self.parse_var_decl()
        if t[1] == "component":
            return self.parse_component_decl()
        if t[1] == "if":
            return self.parse_if()
        if t[1] == "for":
            return self.parse_for()
        if t[1] == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt_as_list()
            return While(cond, body)
        if t[1] == "return":
            self.next()
            v = self.parse_expr()
            self.expect(";")
            return Return(v)
        if t[1] == "assert":
            self.next()
            self.expect("(")
            c = self.parse_expr()
            self.expect(")")
            self.expect(";")
            return Assert(c)
        if t[1] == "log":
            self.next()
            self.expect("(")
            args = []
            if not self.accept(")"):
                while True:
                    if self.peek()[0] == "str":
                        args.append(self.next()[1].strip('"'))
                    else:
                        args.append(self.parse_expr())
                    if not self.accept(","):
                        break
                self.expect(")")
            self.expect(";")
            return Log(args)
        return self.parse_assign_or_expr()

    def parse_stmt_as_list(self):
        s = self.parse_stmt()
        return s if isinstance(s, list) else [s]

    def _parse_dims(self):
        dims = []
        while self.accept("["):
            dims.append(self.parse_expr())
            self.expect("]")
        return dims

    def parse_signal_decl(self):
        self.expect("signal")
        kind = "intermediate"
        if self.peek()[1] in ("input", "output"):
            kind = self.next()[1]
        # optional tag list: signal input {tag, ...} name
        tags = ()
        if self.accept("{"):
            tg = []
            while True:
                tg.append(self.next()[1])
                if not self.accept(","):
                    break
            self.expect("}")
            tags = tuple(tg)
        decls = []
        while True:
            name = self.next()[1]
            dims = self._parse_dims()
            init = None
            init_op = None
            if self.peek()[1] in ("<==", "<--"):
                init_op = self.next()[1]
                init = self.parse_expr()
            decls.append(SignalDecl(name, kind, dims, init, init_op, tags))
            if not self.accept(","):
                break
        self.expect(";")
        return decls if len(decls) > 1 else decls[0]

    def parse_var_decl(self):
        self.expect("var")
        decls = []
        while True:
            name = self.next()[1]
            dims = self._parse_dims()
            init = None
            if self.accept("="):
                init = self.parse_expr()
            decls.append(VarDecl(name, dims, init))
            if not self.accept(","):
                break
        self.expect(";")
        return decls if len(decls) > 1 else decls[0]

    def parse_component_decl(self):
        self.expect("component")
        decls = []
        while True:
            name = self.next()[1]
            dims = self._parse_dims()
            init = None
            if self.accept("="):
                init = self.parse_expr()
            decls.append(ComponentDecl(name, dims, init))
            if not self.accept(","):
                break
        self.expect(";")
        return decls if len(decls) > 1 else decls[0]

    def parse_if(self):
        self.expect("if")
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        then = self.parse_stmt_as_list()
        els = None
        if self.accept("else"):
            els = self.parse_stmt_as_list()
        return If(cond, then, els)

    def parse_for(self):
        self.expect("for")
        self.expect("(")
        if self.peek()[1] == "var":
            init = self.parse_var_decl()  # consumes ';'
        else:
            init = self.parse_assign_or_expr()
        cond = self.parse_expr()
        self.expect(";")
        step = self.parse_assign_no_semi()
        self.expect(")")
        body = self.parse_stmt_as_list()
        return For(init, cond, step, body)

    def parse_assign_or_expr(self):
        s = self.parse_assign_no_semi()
        self.expect(";")
        return s

    ASSIGN_OPS = {
        "=", "<==", "<--", "+=", "-=", "*=", "/=", "\\=", "%=", "**=",
        "<<=", ">>=", "&=", "|=", "^=",
    }

    def parse_assign_no_semi(self):
        e = self.parse_expr()
        t = self.peek()[1]
        if t in self.ASSIGN_OPS:
            self.next()
            v = self.parse_expr()
            # right-constraint form: expr ==> lhs handled below
            return Assign(t, _as_access(e), v)
        if t in ("==>", "-->"):
            self.next()
            lhs = self.parse_expr()
            op = "<==" if t == "==>" else "<--"
            return Assign(op, _as_access(lhs), e)
        if t in ("++", "--"):
            self.next()
            return Assign(t, _as_access(e))
        if t == "===":
            self.next()
            r = self.parse_expr()
            return ConstraintEq(e, r)
        return Assign("expr", None, e)  # bare expression statement

    # -- expressions ---------------------------------------------------------
    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        c = self.parse_or()
        if self.accept("?"):
            t = self.parse_expr()
            self.expect(":")
            f = self.parse_expr()
            return Tern(c, t, f)
        return c

    def _binop(self, sub, ops):
        e = sub()
        while self.peek()[1] in ops:
            op = self.next()[1]
            e = Bin(op, e, sub())
        return e

    def parse_or(self):
        return self._binop(self.parse_and, ("||",))

    def parse_and(self):
        return self._binop(self.parse_cmp, ("&&",))

    def parse_cmp(self):
        return self._binop(
            self.parse_bitor, ("==", "!=", "<", ">", "<=", ">=")
        )

    def parse_bitor(self):
        return self._binop(self.parse_bitxor, ("|",))

    def parse_bitxor(self):
        return self._binop(self.parse_bitand, ("^",))

    def parse_bitand(self):
        return self._binop(self.parse_shift, ("&",))

    def parse_shift(self):
        return self._binop(self.parse_add, ("<<", ">>"))

    def parse_add(self):
        return self._binop(self.parse_mul, ("+", "-"))

    def parse_mul(self):
        return self._binop(self.parse_pow, ("*", "/", "\\", "%"))

    def parse_pow(self):
        e = self.parse_unary()
        if self.peek()[1] == "**":
            self.next()
            return Bin("**", e, self.parse_pow())
        return e

    def parse_unary(self):
        t = self.peek()[1]
        if t in ("-", "!", "~"):
            self.next()
            return Un(t, self.parse_unary())
        if t == "+":
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        t = self.next()
        if t[0] == "num":
            base = 16 if t[1].startswith("0x") else 10
            e = Num(int(t[1], base))
        elif t[1] == "(":
            e = self.parse_expr()
            self.expect(")")
        elif t[1] == "[":
            items = []
            if not self.accept("]"):
                while True:
                    items.append(self.parse_expr())
                    if not self.accept(","):
                        break
                self.expect("]")
            e = ArrayLit(items)
        elif t[0] == "id" or t[1] in KEYWORDS:
            name = t[1]
            if self.peek()[1] == "(":
                self.next()
                args = []
                if not self.accept(")"):
                    while True:
                        args.append(self.parse_expr())
                        if not self.accept(","):
                            break
                    self.expect(")")
                e = Call(name, args)
            else:
                e = Ident(name)
        else:
            raise SyntaxError(f"line {t[2]}: unexpected token {t[1]!r}")
        # postfix chains: [i], .field
        path = []
        while True:
            if self.accept("["):
                path.append(("idx", self.parse_expr()))
                self.expect("]")
            elif self.accept("."):
                path.append(("field", self.next()[1]))
            else:
                break
        if path:
            if isinstance(e, Ident):
                return Access(e.name, path)
            raise SyntaxError(f"line {t[2]}: cannot index {e}")
        return e


def _as_access(e):
    if isinstance(e, Ident):
        return Access(e.name, [])
    if isinstance(e, Access):
        return e
    raise SyntaxError(f"invalid assignment target: {e}")


def parse(src: str) -> Program:
    return Parser(tokenize(src)).parse_program()


def load_program(path: str, search_paths=()) -> Program:
    """Parse a .circom file plus its transitive includes into one Program."""
    import os

    templates, functions = {}, {}
    main = None
    main_public: list = []
    seen = set()

    def visit(p):
        nonlocal main, main_public
        p = os.path.abspath(p)
        if p in seen:
            return
        seen.add(p)
        with open(p) as fh:
            prog = parse(fh.read())
        for inc in prog.includes:
            cands = [os.path.join(os.path.dirname(p), inc)] + [
                os.path.join(sp, inc) for sp in search_paths
            ]
            for c in cands:
                if os.path.exists(c):
                    visit(c)
                    break
            else:
                raise FileNotFoundError(f"include not found: {inc}")
        templates.update(prog.templates)
        functions.update(prog.functions)
        if prog.main is not None:
            main = prog.main
            main_public = prog.main_public

    visit(path)
    out = Program(templates, functions, main, main_public)
    out.includes = []
    return out
