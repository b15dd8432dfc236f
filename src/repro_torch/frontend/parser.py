"""Recursive-descent parser: CUDA-C subset tokens -> kernel AST.

The grammar is the intersection of what Rodinia-style kernels actually
use and what the ``KernelDef`` IR can express: ``__global__`` functions,
``__shared__``/``extern __shared__``/file-scope ``__constant__``
declarations, if/else, constant-``for`` loops, ``__syncthreads()``, and
C expressions (precedence-climbing, C precedence table).  Everything
else raises :class:`~repro_torch.core.kernel.UnsupportedKernel` naming the
source line, so an out-of-subset ``.cu`` fails at the construct, not as
a silent mistranslation downstream.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.kernel import UnsupportedKernel
from repro_torch.frontend.lexer import Token, tokenize

_TYPES = {"int", "float", "double", "bool", "unsigned", "long", "char",
          "uint32_t", "int32_t", "size_t"}
#: C scalar type -> the frontend's coarse type class
TYPE_CLASS = {"float": "float", "double": "float"}


# ---------------------------------------------------------------- AST ----
@dataclasses.dataclass(frozen=True)
class Num:
    value: object           # python int or float
    line: int


@dataclasses.dataclass(frozen=True)
class Name:
    id: str
    line: int


@dataclasses.dataclass(frozen=True)
class Member:
    base: str               # threadIdx | blockIdx | blockDim | gridDim
    field: str              # x | y | z
    line: int


@dataclasses.dataclass(frozen=True)
class Index:
    base: str               # buffer name (pointer param/shared/constant)
    index: object           # Expr
    line: int


@dataclasses.dataclass(frozen=True)
class Unary:
    op: str
    operand: object
    line: int


@dataclasses.dataclass(frozen=True)
class Bin:
    op: str
    lhs: object
    rhs: object
    line: int


@dataclasses.dataclass(frozen=True)
class CondExpr:
    cond: object
    then: object
    els: object
    line: int


@dataclasses.dataclass(frozen=True)
class Call:
    fn: str
    args: tuple
    line: int


@dataclasses.dataclass(frozen=True)
class AddrOf:
    target: Index
    line: int


@dataclasses.dataclass(frozen=True)
class Decl:
    ctype: str
    name: str
    init: object            # Expr | None
    line: int


@dataclasses.dataclass(frozen=True)
class Assign:
    target: object          # Name | Index
    op: str                 # '=' '+=' '-=' ...
    value: object
    line: int


@dataclasses.dataclass(frozen=True)
class If:
    cond: object
    then: tuple
    els: tuple
    line: int


@dataclasses.dataclass(frozen=True)
class For:
    var: str
    start: object           # Expr (must const-fold)
    cond_op: str            # '<' | '<='
    bound: object           # Expr (must const-fold)
    step: object            # Expr (must const-fold; increment amount)
    body: tuple
    line: int


@dataclasses.dataclass(frozen=True)
class Barrier:
    line: int


@dataclasses.dataclass(frozen=True)
class Return:
    line: int


@dataclasses.dataclass(frozen=True)
class ExprStmt:
    expr: object
    line: int


@dataclasses.dataclass(frozen=True)
class Param:
    ctype: str
    name: str
    is_pointer: bool
    is_const: bool
    line: int


@dataclasses.dataclass(frozen=True)
class SharedDecl:
    name: str
    ctype: str
    shape: tuple            # of Expr; () with dynamic=True for extern
    dynamic: bool
    line: int


@dataclasses.dataclass(frozen=True)
class ConstantDecl:
    name: str
    ctype: str
    size: object            # Expr
    line: int


@dataclasses.dataclass(frozen=True)
class KernelAST:
    name: str
    params: tuple           # of Param
    body: tuple             # of Stmt
    shareds: tuple          # of SharedDecl
    line: int


@dataclasses.dataclass(frozen=True)
class TranslationUnitAST:
    kernels: tuple          # of KernelAST
    constants: tuple        # of ConstantDecl


# ------------------------------------------------------------- parser ----
#: binary operator precedence (higher binds tighter), C table
_PREC = {
    "||": 1, "&&": 2, "|": 3, "^": 4, "&": 5,
    "==": 6, "!=": 6,
    "<": 7, "<=": 7, ">": 7, ">=": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
}

_SPECIAL_MEMBERS = {"threadIdx", "blockIdx", "blockDim", "gridDim"}


class _Parser:
    def __init__(self, toks: list[Token]):
        self.toks = toks
        self.pos = 0

    # -- token plumbing ---------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.peek()
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, text: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.text == text

    def at_id(self, text: str) -> bool:
        t = self.peek()
        return t.kind == "id" and t.text == text

    def expect(self, text: str) -> Token:
        t = self.peek()
        if (t.kind == "punct" or t.kind == "id") and t.text == text:
            return self.next()
        found = t.text or "<eof>"
        raise UnsupportedKernel(
            f"line {t.line}: expected {text!r}, found {found!r}")

    def err(self, msg: str) -> UnsupportedKernel:
        return UnsupportedKernel(f"line {self.peek().line}: {msg}")

    # -- top level --------------------------------------------------------
    def parse_unit(self) -> TranslationUnitAST:
        kernels, constants = [], []
        while self.peek().kind != "eof":
            t = self.peek()
            if t.kind == "id" and t.text == "__constant__":
                constants.append(self.parse_constant())
            elif t.kind == "id" and t.text == "__global__":
                kernels.append(self.parse_kernel())
            elif t.kind == "id" and t.text in ("__device__", "__host__"):
                raise self.err(
                    f"{t.text} functions are out of subset (only "
                    f"__global__ kernels and __constant__ declarations)")
            else:
                raise self.err(
                    f"unexpected top-level token {t.text!r} (expected "
                    f"__global__ or __constant__)")
        if not kernels:
            raise UnsupportedKernel("no __global__ kernel found in source")
        return TranslationUnitAST(tuple(kernels), tuple(constants))

    def parse_constant(self) -> ConstantDecl:
        line = self.expect("__constant__").line
        ctype = self.parse_type_name()
        name = self.ident()
        self.expect("[")
        size = self.parse_expr()
        self.expect("]")
        self.expect(";")
        return ConstantDecl(name, ctype, size, line)

    def parse_type_name(self) -> str:
        t = self.peek()
        if t.kind != "id" or t.text not in _TYPES:
            raise self.err(f"expected a type name, found {t.text!r}")
        self.next()
        # 'unsigned int' / 'long long' style two-word types collapse
        while self.peek().kind == "id" and self.peek().text in _TYPES:
            self.next()
        return t.text

    def ident(self) -> str:
        t = self.peek()
        if t.kind != "id":
            raise self.err(f"expected identifier, found {t.text!r}")
        self.next()
        return t.text

    def parse_kernel(self) -> KernelAST:
        line = self.expect("__global__").line
        if not self.at_id("void"):
            raise self.err("__global__ kernels must return void")
        self.next()
        name = self.ident()
        self.expect("(")
        params = []
        while not self.at(")"):
            params.append(self.parse_param())
            if not self.at(")"):
                self.expect(",")
        self.expect(")")
        self.expect("{")
        self._shareds: list[SharedDecl] = []
        body = self.parse_block_items()
        self.expect("}")
        return KernelAST(name, tuple(params), tuple(body),
                         tuple(self._shareds), line)

    def parse_param(self) -> Param:
        line = self.peek().line
        is_const = False
        while self.at_id("const"):
            is_const = True
            self.next()
        ctype = self.parse_type_name()
        while self.at_id("const"):
            is_const = True
            self.next()
        is_pointer = False
        while self.at("*"):
            is_pointer = True
            self.next()
        while self.peek().kind == "id" and self.peek().text in (
                "__restrict__", "restrict", "const"):
            self.next()
        name = self.ident()
        if self.at("["):        # `float a[]` array-of-T parameter form
            self.next()
            self.expect("]")
            is_pointer = True
        return Param(ctype, name, is_pointer, is_const, line)

    # -- statements -------------------------------------------------------
    def parse_block_items(self) -> list:
        items = []
        while not self.at("}"):
            if self.peek().kind == "eof":
                raise self.err("unexpected end of source (missing '}')")
            stmt = self.parse_stmt()
            if stmt is not None:
                items.append(stmt)
        return items

    def parse_stmt(self):
        t = self.peek()
        if t.kind == "id":
            if t.text in ("__shared__", "extern"):
                self.parse_shared_decl()
                return None
            if t.text == "__syncthreads" and self.peek(1).text == "(":
                self.next()
                self.expect("(")
                self.expect(")")
                self.expect(";")
                return Barrier(t.line)
            if t.text == "if":
                return self.parse_if()
            if t.text == "for":
                return self.parse_for()
            if t.text in ("while", "do", "switch", "goto"):
                raise self.err(f"{t.text!r} is out of subset (constant-"
                               f"trip 'for' loops only)")
            if t.text == "return":
                self.next()
                if not self.at(";"):
                    raise self.err("__global__ kernels return void; "
                                   "'return <expr>' is out of subset")
                self.expect(";")
                return Return(t.line)
            if t.text in _TYPES or t.text == "const":
                return self.parse_decl()
        if self.at("{"):
            # bare block: flatten (C scoping narrower than ours; fine for
            # straight-line kernels)
            self.next()
            items = self.parse_block_items()
            self.expect("}")
            return If(Num(1, t.line), tuple(items), (), t.line) \
                if False else _Flat(tuple(items))
        return self.parse_expr_or_assign()

    def parse_shared_decl(self) -> None:
        line = self.peek().line
        dynamic = False
        if self.at_id("extern"):
            self.next()
            dynamic = True
        if not self.at_id("__shared__"):
            raise self.err("expected __shared__ after extern")
        self.next()
        ctype = self.parse_type_name()
        name = self.ident()
        dims = []
        self.expect("[")
        if self.at("]"):
            if not dynamic:
                raise self.err(f"__shared__ {name}[] without a size "
                               f"needs 'extern' (dynamic shared memory)")
            self.next()
        else:
            if dynamic:
                raise self.err("extern __shared__ arrays are unsized "
                               "(size comes from the launch)")
            dims.append(self.parse_expr())
            self.expect("]")
        while self.at("["):
            raise self.err("multi-dimensional __shared__ arrays are out "
                           "of subset (flatten the indexing)")
        self.expect(";")
        self._shareds.append(
            SharedDecl(name, ctype, tuple(dims), dynamic, line))

    def parse_decl(self) -> Decl:
        line = self.peek().line
        while self.at_id("const"):
            self.next()
        ctype = self.parse_type_name()
        if self.at("*"):
            raise self.err("local pointer variables are out of subset")
        name = self.ident()
        init = None
        if self.at("="):
            self.next()
            init = self.parse_expr()
        if self.at(","):
            raise self.err("multi-declarator statements are out of "
                           "subset (one declaration per statement)")
        if self.at("["):
            raise self.err("local arrays are out of subset (use "
                           "__shared__ or registers)")
        self.expect(";")
        return Decl(ctype, name, init, line)

    def parse_if(self) -> If:
        line = self.expect("if").line
        self.expect("(")
        cond = self.parse_expr()
        self.expect(")")
        then = self.parse_branch()
        els: tuple = ()
        if self.at_id("else"):
            self.next()
            if self.at_id("if"):
                els = (self.parse_if(),)
            else:
                els = self.parse_branch()
        return If(cond, then, els, line)

    def parse_branch(self) -> tuple:
        if self.at("{"):
            self.next()
            items = self.parse_block_items()
            self.expect("}")
            return tuple(items)
        stmt = self.parse_stmt()
        return tuple(x for x in ((stmt,) if not isinstance(stmt, _Flat)
                                 else stmt.items) if x is not None)

    def parse_for(self) -> For:
        line = self.expect("for").line
        self.expect("(")
        if not (self.peek().kind == "id" and self.peek().text in _TYPES):
            raise self.err("for-init must declare its loop variable "
                           "(e.g. 'for (int k = 0; ...)')")
        self.parse_type_name()
        var = self.ident()
        self.expect("=")
        start = self.parse_expr()
        self.expect(";")
        cv = self.ident()
        if cv != var:
            raise self.err(f"for-condition must test the loop variable "
                           f"{var!r}")
        if self.at("<"):
            cond_op = "<"
        elif self.at("<="):
            cond_op = "<="
        else:
            raise self.err("for-condition must be '<' or '<=' "
                           "(counting loops only)")
        self.next()
        bound = self.parse_expr()
        self.expect(";")
        iv = self.ident()
        if iv != var:
            raise self.err(f"for-increment must step the loop variable "
                           f"{var!r}")
        if self.at("++"):
            self.next()
            step: object = Num(1, line)
        elif self.at("+="):
            self.next()
            step = self.parse_expr()
        else:
            raise self.err("for-increment must be '++' or '+= <const>'")
        self.expect(")")
        body = self.parse_branch()
        return For(var, start, cond_op, bound, step, body, line)

    def parse_expr_or_assign(self):
        line = self.peek().line
        expr = self.parse_expr()
        if self.at(";"):
            self.next()
            return ExprStmt(expr, line)
        for op in ("=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^="):
            if self.at(op):
                self.next()
                if not isinstance(expr, (Name, Index)):
                    raise UnsupportedKernel(
                        f"line {line}: assignment target must be a "
                        f"variable or a buffer element")
                value = self.parse_expr()
                self.expect(";")
                return Assign(expr, op, value, line)
        if self.at("++") or self.at("--"):
            op = "+=" if self.at("++") else "-="
            self.next()
            self.expect(";")
            if not isinstance(expr, (Name, Index)):
                raise UnsupportedKernel(
                    f"line {line}: ++/-- target must be a variable")
            return Assign(expr, op, Num(1, line), line)
        raise self.err("expected ';' or an assignment operator")

    # -- expressions ------------------------------------------------------
    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_binary(1)
        if self.at("?"):
            line = self.next().line
            then = self.parse_expr()
            self.expect(":")
            els = self.parse_ternary()
            return CondExpr(cond, then, els, line)
        return cond

    def parse_binary(self, min_prec: int):
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind != "punct" or t.text not in _PREC \
                    or _PREC[t.text] < min_prec:
                return lhs
            op = t.text
            self.next()
            rhs = self.parse_binary(_PREC[op] + 1)
            lhs = Bin(op, lhs, rhs, t.line)

    def parse_unary(self):
        t = self.peek()
        if t.kind == "punct" and t.text in ("-", "!", "~", "+"):
            self.next()
            operand = self.parse_unary()
            if t.text == "+":
                return operand
            return Unary(t.text, operand, t.line)
        if t.kind == "punct" and t.text == "&":
            self.next()
            operand = self.parse_unary()
            if not isinstance(operand, Index):
                raise UnsupportedKernel(
                    f"line {t.line}: '&' is only supported on buffer "
                    f"elements (atomic targets)")
            return AddrOf(operand, t.line)
        if t.kind == "punct" and t.text in ("++", "--"):
            raise self.err("pre-increment is out of subset")
        if t.kind == "punct" and t.text == "(":
            # cast or grouping
            if self.peek(1).kind == "id" and self.peek(1).text in _TYPES \
                    and self.peek(2).text == ")":
                self.next()
                ctype = self.parse_type_name()
                self.expect(")")
                operand = self.parse_unary()
                return Call(f"__cast_{TYPE_CLASS.get(ctype, 'int')}",
                            (operand,), t.line)
            self.next()
            inner = self.parse_expr()
            self.expect(")")
            return self.parse_postfix(inner)
        return self.parse_postfix(self.parse_primary())

    def parse_primary(self):
        t = self.peek()
        if t.kind == "int":
            self.next()
            return Num(int(t.text, 0), t.line)
        if t.kind == "float":
            self.next()
            return Num(float(t.text.rstrip("fF")), t.line)
        if t.kind == "id":
            self.next()
            if t.text in _SPECIAL_MEMBERS:
                self.expect(".")
                field = self.ident()
                if field not in ("x", "y", "z"):
                    raise UnsupportedKernel(
                        f"line {t.line}: {t.text}.{field} (fields are "
                        f"x/y/z)")
                return Member(t.text, field, t.line)
            if self.at("("):
                self.next()
                args = []
                while not self.at(")"):
                    args.append(self.parse_expr())
                    if not self.at(")"):
                        self.expect(",")
                self.expect(")")
                return Call(t.text, tuple(args), t.line)
            return Name(t.text, t.line)
        raise self.err(f"unexpected token {t.text!r} in expression")

    def parse_postfix(self, expr):
        while self.at("["):
            line = self.next().line
            idx = self.parse_expr()
            self.expect("]")
            if not isinstance(expr, Name):
                raise UnsupportedKernel(
                    f"line {line}: only named buffers can be subscripted"
                )
            expr = Index(expr.id, idx, line)
            if self.at("["):
                raise UnsupportedKernel(
                    f"line {line}: multi-dimensional subscripts are out "
                    f"of subset (flatten the indexing: a[i * W + j])")
        return expr


@dataclasses.dataclass(frozen=True)
class _Flat:
    """A bare ``{ ... }`` block, flattened into its parent statement list."""
    items: tuple


def parse(src: str, defines: Optional[dict] = None) -> TranslationUnitAST:
    """Parse CUDA-C source into a :class:`TranslationUnitAST`."""
    unit = _Parser(tokenize(src, defines)).parse_unit()
    # flatten bare blocks in kernel bodies
    def flatten(stmts):
        out = []
        for s in stmts:
            if isinstance(s, _Flat):
                out.extend(flatten(s.items))
            elif isinstance(s, If):
                out.append(dataclasses.replace(
                    s, then=tuple(flatten(s.then)),
                    els=tuple(flatten(s.els))))
            elif isinstance(s, For):
                out.append(dataclasses.replace(
                    s, body=tuple(flatten(s.body))))
            else:
                out.append(s)
        return out
    kernels = tuple(
        dataclasses.replace(k, body=tuple(flatten(k.body)))
        for k in unit.kernels)
    return TranslationUnitAST(kernels, unit.constants)
