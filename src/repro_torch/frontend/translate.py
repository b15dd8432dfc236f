"""AST -> ``KernelDef`` translator: the heart of the CUDA-C frontend.

The translator emits *Python source* for each barrier-separated stage and
``exec``s it against a small namespace (``torch``, the carry helper, the
JAX-rule gather and scatter of :mod:`repro_torch.core.index` and the
helpers of :mod:`repro_torch.frontend.runtime`), so a translated kernel
is structurally indistinguishable from a hand-written one: same
``(ctx, st) -> st`` stage signature, same thread-chunk polymorphism, same
fingerprint-hash behavior (all constants are inlined as literals, which
land in ``co_consts`` and hash stably; exec'd functions close over
nothing).

Bit-faithfulness is the design constraint that shapes every emission
rule.  Gathers go through ``index.take`` (JAX clamps an out-of-range
index where torch raises) and stores through ``index.put``, with
conditional stores in the suite's sentinel idiom
(``index.put(arr, where(mask, idx, 1 << 30), v)``, which drops the
sentinel and resolves duplicates last-wins on every device);
``min``/``max`` take Python scalars with JAX's weak typing; C's
left-associative float arithmetic is preserved parenthesis-for-
parenthesis, and atomics call the exact :class:`~repro_torch.core.kernel.Ctx`
entry points the hand-written suite uses - so an ingested ``.cu`` kernel
produces bit-identical buffers to its hand-written twin (enforced by the
``mode="frontend"`` conformance cells).

Divergence is handled with masks, not control flow: an ``if`` body
executes for all threads with its stores masked - the SPMD semantics
every lowering expects.  Barriers must sit in uniform (top-level)
control flow; a ``__syncthreads()`` inside an ``if`` or ``for`` is
diagnosed, not mistranslated.

``unsigned`` (``uint32_t``) ``__shared__`` arrays hold their 32-bit
patterns as int32 and are read into int64 registers holding the pattern,
the representation of the port's ``ballot``; torch's own ``uint32`` has
no arithmetic on the CPU.  Every operation on such a register follows
JAX's uint32 promotion (wrap-around, unsigned comparison against a
literal, int32 arithmetic against a signed tensor), or is refused with
:class:`~repro_torch.core.kernel.UnsupportedKernel`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import index
from repro_torch.core.kernel import KernelDef, UnsupportedKernel
from repro_torch.frontend import parser as P
from repro_torch.frontend import runtime
from repro_torch.frontend.lexer import macro_names

#: out-of-bounds sentinel for masked stores; matches cuda_suite.OOB
OOB = 1 << 30

#: ``__shared__`` element types.  An ``unsigned`` array holds its bits as
#: int32 (see the module docstring); ``double`` narrows to float32 unless
#: the x64 switch is on, through ``KernelDef.resolved_shared``
_DTYPE = {"int": torch.int32, "float": torch.float32,
          "double": torch.float64, "unsigned": torch.int32,
          "uint32_t": torch.int32, "int32_t": torch.int32,
          "bool": torch.bool, "char": torch.int8}

_TYPE_CLASS = {"float": "float", "double": "float"}   # everything else int

#: a ``__shared__`` array's element type class: ``unsigned`` reads are
#: "uint" registers
_SHARED_CLASS = {**_TYPE_CLASS, "unsigned": "uint", "uint32_t": "uint"}

#: C math intrinsics -> (emitted call, result type class).  ``{}`` takes
#: the arguments; min/max/pow lift Python scalars with JAX's weak rules
_MATH = {
    "min": ("_rt.minimum(ctx, {})", None),
    "max": ("_rt.maximum(ctx, {})", None),
    "fminf": ("_rt.minimum(ctx, {})", "float"),
    "fmaxf": ("_rt.maximum(ctx, {})", "float"),
    "fmin": ("_rt.minimum(ctx, {})", "float"),
    "fmax": ("_rt.maximum(ctx, {})", "float"),
    "abs": ("_rt.unary(torch.abs, ctx, {})", None),
    "fabs": ("_rt.unary(torch.abs, ctx, {})", "float"),
    "fabsf": ("_rt.unary(torch.abs, ctx, {})", "float"),
    "expf": ("_rt.unary(torch.exp, ctx, {})", "float"),
    "exp": ("_rt.unary(torch.exp, ctx, {})", "float"),
    "logf": ("_rt.unary(torch.log, ctx, {})", "float"),
    "log": ("_rt.unary(torch.log, ctx, {})", "float"),
    "sqrtf": ("_rt.unary(torch.sqrt, ctx, {})", "float"),
    "sqrt": ("_rt.unary(torch.sqrt, ctx, {})", "float"),
    "powf": ("_rt.power(ctx, {})", "float"),
    "pow": ("_rt.power(ctx, {})", "float"),
}

_SHFL = {"__shfl_sync": "ctx.shfl", "__shfl_up_sync": "ctx.shfl_up",
         "__shfl_down_sync": "ctx.shfl_down",
         "__shfl_xor_sync": "ctx.shfl_xor"}

_VOTE = {"__ballot_sync": "ctx.ballot", "__all_sync": "ctx.vote_all",
         "__any_sync": "ctx.vote_any"}

_ATOMICS = ("atomicAdd", "atomicMax", "atomicMin", "atomicCAS",
            "atomicExch")

#: the names of the generated code's namespace and stage signature
_RESERVED = {"ctx", "st", "torch", "_carry", "_take", "_put", "_rt",
             "range"}

#: ``_Translator._weak`` kinds of an operand that is no folded value
_WEAK = "weak"
_UNSURE = "unsure"

#: binary operators whose "uint" result wraps to 32 bits
_WRAPS = ("+", "-", "*", "<<")


@dataclasses.dataclass(frozen=True)
class TranslatedKernel:
    """A ``.cu`` kernel after translation.

    ``kernel`` is the ready-to-launch :class:`KernelDef`; ``sources``
    holds the generated Python per stage (also attached to each stage
    function as ``__cuda_source__`` for debugging); ``constants`` names
    the file-scope ``__constant__`` buffers the kernel expects in the
    heap (bind them via ``SuiteEntry.const`` / ``ConstArray``).
    """

    kernel: KernelDef
    sources: tuple[str, ...]
    cu_name: str
    params: tuple[str, ...]
    constants: tuple[str, ...]


def _err(line: int, msg: str) -> UnsupportedKernel:
    return UnsupportedKernel(f"line {line}: {msg}")


_FOLD_OPS = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
             "*": lambda a, b: a * b, "%": lambda a, b: a % b,
             "<<": lambda a, b: a << b, ">>": lambda a, b: a >> b,
             "/": lambda a, b: a // b if isinstance(a, int)
             and isinstance(b, int) else a / b}


def _fold(e, binds: dict | None = None) -> int | float:
    """Constant-fold an expression (shared shapes, loop bounds, and the
    Python-scalar operands an ``unsigned`` register meets); ``binds``
    gives bound scalar parameters their values."""
    if isinstance(e, P.Num):
        return e.value
    if isinstance(e, P.Name) and binds and e.id in binds:
        return binds[e.id]
    if isinstance(e, P.Unary) and e.op == "-":
        return -_fold(e.operand, binds)
    if isinstance(e, P.Bin) and e.op in _FOLD_OPS:
        return _FOLD_OPS[e.op](_fold(e.lhs, binds), _fold(e.rhs, binds))
    line = getattr(e, "line", 0)
    raise _err(line, "expression must be a compile-time constant here "
                     "(array sizes and for-loop bounds)")


def _unify(a: str, b: str) -> str:
    if "float" in (a, b):
        return "float"
    if a == "bool" and b == "bool":
        return "bool"
    return "int"


class _Translator:
    def __init__(self, kernel: P.KernelAST,
                 constants: tuple[P.ConstantDecl, ...],
                 scalar_bind: dict):
        self.k = kernel
        # buffer name -> element type class
        self.globals: dict[str, str] = {}
        self.const_names: list[str] = []
        self.param_order: list[str] = []
        for c in constants:
            _fold(c.size)                      # must be constant; validates
            self.globals[c.name] = _TYPE_CLASS.get(c.ctype, "int")
            self.const_names.append(c.name)
        self.scalar_bind = dict(scalar_bind)
        for p in kernel.params:
            self._check_name(p.name, p.line)
            if p.is_pointer:
                self.globals[p.name] = _TYPE_CLASS.get(p.ctype, "int")
                self.param_order.append(p.name)
            elif p.name not in self.scalar_bind:
                raise _err(
                    p.line,
                    f"scalar parameter {p.name!r} has no launch value: "
                    f"pass bind={{{p.name!r}: <value>}} to translate() "
                    f"(scalar kernel arguments are specialized at "
                    f"translation time, the POCL-style JIT idiom)")
        self.shared_spec: dict[str, tuple] = {}
        self.shared_type: dict[str, str] = {}
        for sd in kernel.shareds:
            self._check_name(sd.name, sd.line)
            if sd.name in self.globals:
                raise _err(sd.line, f"__shared__ {sd.name!r} shadows a "
                                    f"kernel parameter")
            dt = _DTYPE.get(sd.ctype)
            if dt is None:
                raise _err(sd.line, f"unsupported __shared__ element type "
                                    f"{sd.ctype!r}")
            shape = ((-1,) if sd.dynamic
                     else (int(_fold(sd.shape[0])),))
            self.shared_spec[sd.name] = (shape, dt)
            self.shared_type[sd.name] = _SHARED_CLASS.get(sd.ctype, "int")

        self.locals: dict[str, str] = {}       # name -> type class
        self.local_kind: dict[str, object] = {}  # name -> _weak kind
        self.written: set[str] = set()         # global buffers stored to
        self.uses_warp = False
        self.tmp = 0
        # per-stage emission state
        self.lines: list[str] = []
        self.indent = 1
        self.mask: str | None = None

    def _check_name(self, name: str, line: int):
        if name in _RESERVED or name.startswith("_"):
            raise _err(line, f"identifier {name!r} collides with the "
                             f"translation runtime (reserved names: "
                             f"{sorted(_RESERVED)}, leading underscores)")

    # ------------------------------------------------------------------
    def run(self) -> tuple[list[str], dict]:
        stages = self._split_stages()
        scans = [self._scan(s) for s in stages]
        local_defs: dict[str, int] = {}
        for i, (refs, defs, _members) in enumerate(scans):
            for d in defs:
                local_defs.setdefault(d, i)

        def carry_set(barrier: int) -> list[str]:
            out = set()
            for v, ds in local_defs.items():
                if ds <= barrier and any(
                        v in scans[j][0] for j in
                        range(barrier + 1, len(stages))):
                    out.add(v)
            return sorted(out)

        any_carry = any(carry_set(i) for i in range(len(stages) - 1))
        sources = []
        for i, body in enumerate(stages):
            refs, _defs, members = scans[i]
            carried_in = carry_set(i - 1) if i > 0 else []
            carried_out = carry_set(i) if i < len(stages) - 1 else []
            src = self._emit_stage(i, body, refs, members, carried_in,
                                   carried_out,
                                   final=(i == len(stages) - 1),
                                   any_carry=any_carry)
            sources.append(src)
        writes = tuple(n for n in self.param_order if n in self.written)
        if not writes:
            raise UnsupportedKernel(
                f"kernel {self.k.name}: no global buffer is ever written "
                f"(a kernel with no observable effect is out of subset)")
        reads = tuple(self.param_order) + tuple(self.const_names)
        meta = {"writes": writes, "reads": reads,
                "shared": dict(self.shared_spec),
                "uses_warp": self.uses_warp}
        return sources, meta

    def _split_stages(self) -> list[list]:
        stages, cur = [], []
        for stmt in self.k.body:
            if isinstance(stmt, P.Barrier):
                stages.append(cur)
                cur = []
            else:
                cur.append(stmt)
        stages.append(cur)
        return stages

    # ------------------------------------------------------------------
    def _scan(self, stmts) -> tuple[set, set, set]:
        """(referenced identifiers, declared locals, special members)."""
        refs: set[str] = set()
        defs: set[str] = set()
        members: set[str] = set()

        def expr(e):
            if isinstance(e, P.Name):
                refs.add(e.id)
            elif isinstance(e, P.Member):
                members.add(e.base)
            elif isinstance(e, P.Index):
                refs.add(e.base)
                expr(e.index)
            elif isinstance(e, P.Unary):
                expr(e.operand)
            elif isinstance(e, P.Bin):
                expr(e.lhs)
                expr(e.rhs)
            elif isinstance(e, P.CondExpr):
                expr(e.cond)
                expr(e.then)
                expr(e.els)
            elif isinstance(e, P.Call):
                for a in e.args:
                    expr(a)
            elif isinstance(e, P.AddrOf):
                expr(e.target)

        def stmt(s):
            if isinstance(s, P.Decl):
                defs.add(s.name)
                if s.init is not None:
                    expr(s.init)
            elif isinstance(s, P.Assign):
                expr(s.target)
                expr(s.value)
            elif isinstance(s, P.If):
                expr(s.cond)
                for x in s.then:
                    stmt(x)
                for x in s.els:
                    stmt(x)
            elif isinstance(s, P.For):
                defs.add(s.var)
                for x in (s.start, s.bound, s.step):
                    expr(x)
                for x in s.body:
                    stmt(x)
            elif isinstance(s, P.ExprStmt):
                expr(s.expr)

        for s in stmts:
            stmt(s)
        return refs, defs, members

    # ------------------------------------------------------------------
    def _emit_stage(self, i: int, body, refs, members, carried_in,
                    carried_out, final: bool, any_carry: bool) -> str:
        self.lines = [f"def stage_{i}(ctx, st):"]
        self.indent = 1
        self.mask = None
        self.final_stage = final
        self.stage_written: set[str] = set()
        self.stage_shared_written: set[str] = set()
        if "threadIdx" in members:
            self.emit("_tidx, _tidy, _tidz = ctx.tid3")
        if "blockIdx" in members:
            self.emit("_bidx, _bidy, _bidz = ctx.bid3")
        for name in self.param_order + self.const_names:
            if name in refs:
                self.emit(f'{name} = st.glob["{name}"]')
        for name in self.shared_spec:
            if name in refs:
                self.emit(f'{name} = st.shared["{name}"]')
        for name in carried_in:
            self.emit(f'{name} = st.priv["{name}"]')
            self.local_kind.pop(name, None)    # _carry made it a tensor
        self._stmts(body)
        sw = [n for n in self.shared_spec if n in self.stage_shared_written]
        if sw:
            self.emit("st = st.set_shared("
                      + ", ".join(f"{n}={n}" for n in sw) + ")")
        gw = [n for n in self.param_order if n in self.stage_written]
        if gw:
            self.emit("st = st.set_glob("
                      + ", ".join(f"{n}={n}" for n in gw) + ")")
        if carried_out:
            kv = ", ".join(f'"{n}": _carry({n}, ctx.tid)'
                           for n in carried_out)
            self.emit("st = st.with_priv({" + kv + "})")
        elif any_carry and (final or i > 0):
            self.emit("st = st.with_priv({})")
        self.emit("return st")
        return "\n".join(self.lines) + "\n"

    def emit(self, line: str):
        self.lines.append("    " * self.indent + line)

    def _tmpname(self, prefix: str) -> str:
        self.tmp += 1
        return f"_{prefix}{self.tmp}"

    # ---- statements ---------------------------------------------------
    def _stmts(self, stmts):
        outer_mask = self.mask
        it = iter(enumerate(stmts))
        for pos, s in it:
            if isinstance(s, P.Barrier):
                raise _err(s.line,
                           "__syncthreads() inside an if/for body: "
                           "barriers must sit in uniform top-level "
                           "control flow (the fission points)")
            if isinstance(s, P.Return):
                if not self.final_stage:
                    raise _err(s.line, "'return' before a later "
                                       "__syncthreads(): returning past a "
                                       "barrier other threads reach is "
                                       "undefined in CUDA")
                if self.mask is not None:
                    raise _err(s.line, "'return' under divergent control "
                                       "flow must be the lone statement "
                                       "of its if-body")
                break                          # dead code after return
            if (isinstance(s, P.If) and len(s.then) == 1 and not s.els
                    and isinstance(s.then[0], P.Return)):
                if not self.final_stage:
                    raise _err(s.then[0].line,
                               "'return' before a later __syncthreads(): "
                               "returning past a barrier other threads "
                               "reach is undefined in CUDA")
                self._early_return(s, stmts[pos + 1:])
                self.mask = outer_mask
                return
            self._stmt(s)
        self.mask = outer_mask

    def _cond(self, e) -> str:
        """Emit a branch condition into a temporary bool tensor."""
        cond, ct = self._expr(e)
        cv = self._tmpname("c")
        self.emit(f"{cv} = _rt.cond(ctx, {self._bool(cond, ct)})")
        return cv

    def _early_return(self, s: P.If, rest):
        cv = self._cond(s.cond)
        keep = (f"({self.mask} & (~{cv}))" if self.mask is not None
                else f"(~{cv})")
        mv = self._tmpname("m")
        self.emit(f"{mv} = {keep}")
        self.mask = mv
        self._stmts(rest)

    def _stmt(self, s):
        if isinstance(s, P.Decl):
            self._check_name(s.name, s.line)
            if s.name in self.globals or s.name in self.shared_spec:
                raise _err(s.line, f"local {s.name!r} shadows a buffer")
            if s.init is None:
                raise _err(s.line, f"local {s.name!r} must be "
                                   f"initialized at declaration")
            if self._is_atomic_call(s.init):
                self._atomic(s.init, capture=s.name)
                return
            code, t = self._expr(s.init)
            self.emit(f"{s.name} = {code}")
            self._set_local(s.name, t, self._weak(s.init))
        elif isinstance(s, P.Assign):
            self._assign(s)
        elif isinstance(s, P.If):
            self._if(s)
        elif isinstance(s, P.For):
            self._for(s)
        elif isinstance(s, P.ExprStmt):
            if self._is_atomic_call(s.expr):
                self._atomic(s.expr, capture=None)
            else:
                raise _err(s.line, "expression statement has no effect "
                                   "(only atomic calls may stand alone)")
        else:                                   # pragma: no cover
            raise _err(getattr(s, "line", 0),
                       f"unsupported statement {type(s).__name__}")

    def _assign(self, s: P.Assign):
        if isinstance(s.target, P.Name):
            name = s.target.id
            if name in self.globals or name in self.shared_spec:
                raise _err(s.line, f"cannot assign a whole buffer "
                                   f"({name!r}); store to an element")
            if self._is_atomic_call(s.value) and s.op == "=":
                self._atomic(s.value, capture=name)
                return
            value = s.value
            if s.op != "=":
                value = P.Bin(s.op[:-1], s.target, s.value, s.line)
            code, t = self._expr(value)
            if self.mask is not None:
                if name not in self.locals:
                    raise _err(s.line,
                               f"{name!r} assigned under an if but never "
                               f"declared before it (masked assignment "
                               f"needs a prior value)")
                kinds = (self._weak(value), self.local_kind.get(name))
                a, b, t = self._coerce((code, t, kinds[0]),
                                       (name, self.locals[name], kinds[1]),
                                       s.line)
                self.emit(f"{name} = _rt.where(ctx, {self.mask}, {a}, {b})")
                self._set_local(name, t, None if None in kinds else _UNSURE)
            else:
                self.emit(f"{name} = {code}")
                self._set_local(name, t, self._weak(value))
            return
        # buffer element store
        buf, idx_e = s.target.base, s.target.index
        if buf in self.locals:
            raise _err(s.line, f"cannot subscript local {buf!r}")
        if buf in self.const_names:
            raise _err(s.line, f"store to __constant__ buffer {buf!r}")
        is_shared = buf in self.shared_spec
        if not is_shared and buf not in self.globals:
            raise _err(s.line, f"store to unknown buffer {buf!r}")
        idx, _ = self._expr(idx_e)
        if s.op in ("=", "+=", "-="):
            val, vt = self._expr(s.value)
            if is_shared and self.shared_type[buf] == "uint" \
                    and vt == "float":
                raise _err(s.line, f"float value stored to unsigned "
                                   f"__shared__ {buf!r} is out of subset "
                                   f"(JAX's float-to-uint32 conversion "
                                   f"has no exact torch counterpart)")
        if s.op == "=":
            op, args = "set", val
        elif s.op in ("+=", "-="):
            args = val if s.op == "+=" else f"(-{val})"
            op = "add"
        else:
            raise _err(s.line, f"{s.op!r} on a buffer element is out of "
                               f"subset (use = / += / -=)")
        if self.mask is not None:
            idx = f"_rt.where(ctx, {self.mask}, {idx}, {OOB})"
            self.emit(f'{buf} = _put({buf}, {idx}, {args}, "{op}")')
        else:
            # an unmasked store asks for no drop (JAX's plain .at[i]):
            # kernelcheck reports its out-of-range positions
            self.emit(f'{buf} = _put({buf}, {idx}, {args}, "{op}", '
                      f'drop=False)')
        if is_shared:
            self.stage_shared_written.add(buf)
        else:
            self.written.add(buf)
            self.stage_written.add(buf)

    def _if(self, s: P.If):
        cv = self._cond(s.cond)
        outer = self.mask
        then_mask = cv if outer is None else f"({outer} & {cv})"
        mv = self._tmpname("m")
        self.emit(f"{mv} = {then_mask}")
        self.mask = mv
        self._stmts(s.then)
        if s.els:
            els_mask = (f"(~{cv})" if outer is None
                        else f"({outer} & (~{cv}))")
            ev = self._tmpname("m")
            self.emit(f"{ev} = {els_mask}")
            self.mask = ev
            self._stmts(s.els)
        self.mask = outer

    def _for(self, s: P.For):
        self._check_name(s.var, s.line)
        start, bound, step = _fold(s.start), _fold(s.bound), _fold(s.step)
        if not all(isinstance(v, int) for v in (start, bound, step)):
            raise _err(s.line, "for-loop bounds must be integer constants")
        if step <= 0:
            raise _err(s.line, "for-loop step must be positive")
        stop = bound + 1 if s.cond_op == "<=" else bound
        self.emit(f"for {s.var} in range({start}, {stop}, {step}):")
        self._set_local(s.var, "int", _WEAK)
        self.indent += 1
        self._stmts(s.body)
        self.indent -= 1

    # ---- atomics ------------------------------------------------------
    def _is_atomic_call(self, e) -> bool:
        return isinstance(e, P.Call) and e.fn in _ATOMICS

    def _atomic(self, call: P.Call, capture: str | None):
        fn, line = call.fn, call.line
        nargs = {"atomicAdd": 2, "atomicMax": 2, "atomicMin": 2,
                 "atomicExch": 2, "atomicCAS": 3}[fn]
        if len(call.args) != nargs:
            raise _err(line, f"{fn} takes {nargs} arguments")
        target = call.args[0]
        if not isinstance(target, P.AddrOf):
            raise _err(line, f"{fn}'s first argument must be "
                             f"&buffer[index]")
        buf, idx_e = target.target.base, target.target.index
        if buf in self.shared_spec:
            raise _err(line, f"{fn} on __shared__ memory is out of "
                             f"subset (global buffers only)")
        if buf in self.const_names:
            raise _err(line, f"{fn} on __constant__ buffer {buf!r}")
        if buf not in self.globals:
            raise _err(line, f"{fn} on unknown buffer {buf!r}")
        idx, _ = self._expr(idx_e)
        # a scalar index (e.g. &buf[0]) must fan out to the thread axis:
        # ctx atomics serialize per-thread and index idx[t]
        idx = f"_rt.atomic_index(ctx, {idx})"
        elem_t = self.globals[buf]
        if fn in ("atomicAdd", "atomicMax", "atomicMin"):
            if capture is not None:
                raise _err(line, f"capturing the old value of {fn} is "
                                 f"out of subset (only atomicCAS and "
                                 f"atomicExch return it here)")
            if self.mask is not None:
                idx = f"_rt.where(ctx, {self.mask}, {idx}, {OOB})"
            val, _ = self._expr(call.args[1])
            meth = {"atomicAdd": "atomic_add", "atomicMax": "atomic_max",
                    "atomicMin": "atomic_min"}[fn]
            self.emit(f"{buf} = ctx.{meth}({buf}, {idx}, {val})")
        else:
            # cas/exch never match/always store: mask by sending inactive
            # threads to index == len(buf), which _serial_rmw treats as
            # inactive (the negative/past-the-end contract)
            if self.mask is not None:
                idx = (f"_rt.where(ctx, {self.mask}, {idx}, "
                       f"{buf}.shape[0])")
            old = self._tmpname("old")
            if fn == "atomicCAS":
                cmp_c, _ = self._expr(call.args[1])
                val, _ = self._expr(call.args[2])
                self.emit(f"{buf}, {old} = ctx.atomic_cas({buf}, {idx}, "
                          f"{cmp_c}, {val})")
            else:
                val, _ = self._expr(call.args[1])
                self.emit(f"{buf}, {old} = ctx.atomic_exch({buf}, {idx}, "
                          f"{val})")
            if capture is not None:
                self._check_name(capture, line)
                self.emit(f"{capture} = {old}")
                self._set_local(capture, elem_t, None)
        self.written.add(buf)
        self.stage_written.add(buf)

    def _set_local(self, name: str, t: str, kind):
        self.locals[name] = t
        if kind is None:
            self.local_kind.pop(name, None)
        else:
            self.local_kind[name] = _UNSURE if kind is _UNSURE else _WEAK

    # ---- expressions --------------------------------------------------
    def _bool(self, code: str, t: str) -> str:
        return code if t == "bool" else f"({code} != 0)"

    def _weak(self, e):
        """How JAX types ``e`` as an operand: its value when it folds to
        a Python scalar (a literal, a ``#define``, a bound parameter),
        ``_WEAK`` for another Python scalar of the generated code
        (``blockDim``, ``gridDim``, a loop counter, a local holding such
        a value, arithmetic of those), ``_UNSURE`` where the reference
        keeps a weak type that the port does not track (``min``/``max``,
        ``?:`` or a masked assignment of Python scalars), None for a
        tensor."""
        try:
            return _fold(e, self.scalar_bind)
        except UnsupportedKernel:
            pass
        if isinstance(e, P.Member):
            return _WEAK if e.base in ("blockDim", "gridDim") else None
        if isinstance(e, P.Name):
            return self.local_kind.get(e.id)
        if isinstance(e, P.Unary):
            k = self._weak(e.operand)
            return None if k is None else (_UNSURE if k is _UNSURE
                                           else _WEAK)
        if isinstance(e, (P.Bin, P.CondExpr, P.Call)):
            parts = ((e.lhs, e.rhs) if isinstance(e, P.Bin) else
                     (e.cond, e.then, e.els) if isinstance(e, P.CondExpr)
                     else e.args)
            kinds = [self._weak(x) for x in parts]
            if any(k is None for k in kinds):
                return None
            if isinstance(e, P.Bin) and _UNSURE not in kinds:
                return _WEAK
            return _UNSURE
        return None

    def _coerce(self, a, b, line: int) -> tuple[str, str, str]:
        """Two operands ``(code, type class, _weak kind)`` of one
        operation, converted as JAX promotes them: ``(code_a, code_b,
        result class)``.  An integer tensor meeting a float scalar takes
        JAX's default float type; an ``unsigned`` register meeting a
        Python int takes it modulo 2**32 and stays unsigned, and meeting
        a signed tensor turns into int32 bits (:func:`runtime.signed`)."""
        (ac, at, ak), (bc, bt, bk) = a, b
        if "uint" not in (at, bt):
            if at == "float" and ak is not None and bk is None \
                    and bt in ("int", "bool"):
                bc = f"_rt.tofloat({bc})"
            elif bt == "float" and bk is not None and ak is None \
                    and at in ("int", "bool"):
                ac = f"_rt.tofloat({ac})"
            return ac, bc, (at if at == bt else _unify(at, bt))
        if at == bt:
            return ac, bc, "uint"
        swap = at != "uint"
        (uc, _, _), (oc, ot, ok) = (b, a) if swap else (a, b)
        if ok is _UNSURE:
            raise _err(line, "an unsigned value meets a scalar whose weak "
                             "type the translation does not track (the "
                             "result of min/max, ?: or a masked "
                             "assignment); bind it to a local first")
        if ot == "float":
            if ok is not None:
                uc = f"_rt.tofloat({uc})"
            res = "float"
        elif ok is _WEAK:
            oc, res = f"({oc} & {runtime.U32})", "uint"
        elif ok is not None:
            oc, res = repr(int(ok) & runtime.U32), "uint"
        elif ot == "bool":
            res = "uint"
        else:
            uc, res = f"_rt.signed({uc})", "int"
        return (oc, uc, res) if swap else (uc, oc, res)

    def _expr(self, e) -> tuple[str, str]:
        if isinstance(e, P.Num):
            return repr(e.value), \
                "float" if isinstance(e.value, float) else "int"
        if isinstance(e, P.Name):
            if e.id in self.locals:
                return e.id, self.locals[e.id]
            if e.id in self.scalar_bind:
                v = self.scalar_bind[e.id]
                return repr(v), \
                    "float" if isinstance(v, float) else "int"
            if e.id in self.globals or e.id in self.shared_spec:
                raise _err(e.line, f"buffer {e.id!r} used as a scalar "
                                   f"value (subscript it)")
            raise _err(e.line, f"unknown identifier {e.id!r}")
        if isinstance(e, P.Member):
            if e.base == "threadIdx":
                return f"_tid{e.field}", "int"
            if e.base == "blockIdx":
                return f"_bid{e.field}", "int"
            if e.base == "blockDim":
                return f"ctx.block_dim3.{e.field}", "int"
            return f"ctx.grid_dim3.{e.field}", "int"
        if isinstance(e, P.Index):
            base = e.base
            if base in self.locals:
                raise _err(e.line, f"cannot subscript local {base!r}")
            if base not in self.globals and base not in self.shared_spec:
                raise _err(e.line, f"unknown buffer {base!r}")
            idx, _ = self._expr(e.index)
            t = (self.shared_type[base] if base in self.shared_spec
                 else self.globals[base])
            if t == "uint":
                return f"_rt.u32(_take({base}, {idx}))", t
            return f"_take({base}, {idx})", t
        if isinstance(e, P.Unary):
            code, t = self._expr(e.operand)
            if e.op == "-":
                return ((f"_rt.u32(-{code})", t) if t == "uint"
                        else (f"(-{code})", t))
            if e.op == "!":
                return (f"torch.logical_not(_rt.cond(ctx, "
                        f"{self._bool(code, t)}))", "bool")
            if t == "uint":                     # '~'
                return f"_rt.u32(~{code})", "uint"
            return f"(~{code})", "int"
        if isinstance(e, P.Bin):
            return self._bin(e)
        if isinstance(e, P.CondExpr):
            c, ct = self._expr(e.cond)
            a, at = self._expr(e.then)
            b, bt = self._expr(e.els)
            a, b, t = self._coerce((a, at, self._weak(e.then)),
                                   (b, bt, self._weak(e.els)), e.line)
            return (f"_rt.where(ctx, {self._bool(c, ct)}, {a}, {b})", t)
        if isinstance(e, P.Call):
            return self._call(e)
        if isinstance(e, P.AddrOf):
            raise _err(e.line, "'&buffer[i]' is only valid as an atomic "
                               "target")
        raise _err(getattr(e, "line", 0),        # pragma: no cover
                   f"unsupported expression {type(e).__name__}")

    def _bin(self, e: P.Bin) -> tuple[str, str]:
        lc, lt = self._expr(e.lhs)
        rc, rt = self._expr(e.rhs)
        op = e.op
        if op in ("&&", "||"):
            py = "&" if op == "&&" else "|"
            return (f"({self._bool(lc, lt)} {py} {self._bool(rc, rt)})",
                    "bool")
        lc, rc, t = self._coerce((lc, lt, self._weak(e.lhs)),
                                 (rc, rt, self._weak(e.rhs)), e.line)
        if op in ("==", "!=", "<", "<=", ">", ">="):
            return f"({lc} {op} {rc})", "bool"
        if op == "/":
            if t in ("int", "uint", "bool"):
                # C truncates toward zero; // floors.  Equal for the
                # non-negative operands the subset's kernels use -
                # documented limitation (docs/frontend.md)
                return f"({lc} // {rc})", "uint" if t == "uint" else "int"
            return f"({lc} / {rc})", "float"
        if op in ("&", "|", "^"):
            if t == "bool" or t == "uint":
                return f"({lc} {op} {rc})", t
            return f"({lc} {op} {rc})", "int"
        if op in ("<<", ">>", "%"):
            if t == "uint":
                code = f"({lc} {op} {rc})"
                return (f"_rt.u32{code}" if op == "<<" else code), "uint"
            return f"({lc} {op} {rc})", "int"
        code = f"({lc} {op} {rc})"                  # + - *
        if t == "uint" and op in _WRAPS:
            return f"_rt.u32{code}", "uint"
        return code, t

    def _call(self, e: P.Call) -> tuple[str, str]:
        fn = e.fn
        if fn in _MATH:
            tmpl, rt = _MATH[fn]
            parts = [self._expr(a) for a in e.args]
            codes = [c for c, _ in parts]
            types = [t for _, t in parts]
            if "uint" in types:
                if fn not in ("min", "max") or len(parts) != 2:
                    raise _err(e.line, f"{fn} of an unsigned value is out "
                                       f"of subset")
                a, b, t = self._coerce(
                    (codes[0], types[0], self._weak(e.args[0])),
                    (codes[1], types[1], self._weak(e.args[1])), e.line)
                return tmpl.format(f"{a}, {b}"), t
            t = rt
            if t is None:
                t = "int"
                for at in types:
                    t = _unify(t, at)
            return tmpl.format(", ".join(codes)), t
        if fn == "__syncthreads_count":
            if len(e.args) != 1:
                raise _err(e.line, "__syncthreads_count takes 1 argument")
            if self.mask is not None:
                raise _err(e.line, "__syncthreads_count inside divergent "
                                   "control flow")
            self.uses_warp = True
            c, t = self._expr(e.args[0])
            return f"ctx.syncthreads_count({self._bool(c, t)})", "int"
        if fn in _SHFL:
            if len(e.args) != 3:
                raise _err(e.line, f"{fn} takes (mask, value, lane/delta)")
            if self.mask is not None:
                raise _err(e.line, f"{fn} inside divergent control flow")
            self.uses_warp = True
            v, vt = self._expr(e.args[1])
            lane, _ = self._expr(e.args[2])
            return f"{_SHFL[fn]}({v}, {lane})", vt
        if fn in _VOTE:
            if len(e.args) != 2:
                raise _err(e.line, f"{fn} takes (mask, predicate)")
            if self.mask is not None:
                raise _err(e.line, f"{fn} inside divergent control flow")
            self.uses_warp = True
            c, t = self._expr(e.args[1])
            # the ballot's mask is an unsigned register (int64 pattern)
            rt = "uint" if fn == "__ballot_sync" else "bool"
            return f"{_VOTE[fn]}({self._bool(c, t)})", rt
        if fn in _ATOMICS:
            raise _err(e.line,
                       f"{fn} must stand alone as a statement or "
                       f"initialize a variable (old = {fn}(...))")
        if fn.startswith("__cast_"):
            raise _err(e.line, "C casts are out of subset (the frontend "
                               "keeps CUDA's weak literal typing)")
        raise _err(e.line, f"unknown function {fn!r}")


#: the generated code's namespace (names in ``_RESERVED``)
_NAMESPACE = {"torch": torch, "_carry": runtime.carry, "_take": index.take,
              "_put": index.put, "_rt": runtime}


def translate(src: str, *, bind: dict | None = None,
              combines: dict | None = None,
              donates: tuple | None = None,
              est_block_work: float | None = None,
              name: str | None = None) -> TranslatedKernel:
    """Translate CUDA-C source into a launchable :class:`KernelDef`.

    ``bind`` maps names to Python scalars: names that are ``#define``
    macros in the source override the macro table (the frontend gate's
    ``--inject`` self-test plants a mistranslation this way); other
    names bind scalar kernel parameters (``int n``), which are inlined
    as literals.  ``combines``/``donates``/``est_block_work`` pass
    through to the :class:`KernelDef` - cross-shard merge modes and
    donation are launch-contract declarations CUDA source cannot
    express.  ``name`` picks one ``__global__`` kernel when the source
    holds several.  The kernel has no ``Native`` descriptor: the ``cuda``
    backend refuses it (a Table-II 'unsupport'), and the ``loop`` and
    ``vector`` lowerings run its stages on the buffers' device.
    """
    bind = dict(bind or {})
    macros = macro_names(src)
    lex_defines = {k: v for k, v in bind.items() if k in macros}
    scalar_bind = {k: v for k, v in bind.items() if k not in macros}
    unit = P.parse(src, lex_defines)
    if name is None:
        if len(unit.kernels) > 1:
            raise UnsupportedKernel(
                f"source defines {len(unit.kernels)} kernels "
                f"({', '.join(k.name for k in unit.kernels)}); pass "
                f"name= to pick one")
        kast = unit.kernels[0]
    else:
        match = [k for k in unit.kernels if k.name == name]
        if not match:
            raise UnsupportedKernel(
                f"no __global__ kernel named {name!r} in source (have: "
                f"{', '.join(k.name for k in unit.kernels)})")
        kast = match[0]

    tr = _Translator(kast, unit.constants, scalar_bind)
    sources, meta = tr.run()

    ns = dict(_NAMESPACE)
    stage_fns = []
    for i, stage_src in enumerate(sources):
        code = compile(stage_src, f"<cuda:{kast.name}:stage{i}>", "exec")
        exec(code, ns)
        fn = ns[f"stage_{i}"]
        fn.__cuda_source__ = stage_src
        stage_fns.append(fn)

    kw = {}
    if est_block_work is not None:
        kw["est_block_work"] = est_block_work
    kernel = KernelDef(
        kast.name, tuple(stage_fns), writes=meta["writes"],
        shared=meta["shared"], reads=meta["reads"],
        uses_warp=meta["uses_warp"], combines=dict(combines or {}),
        donates=tuple(donates or ()), **kw)
    return TranslatedKernel(
        kernel=kernel, sources=tuple(sources), cu_name=kast.name,
        params=tuple(tr.param_order), constants=tuple(tr.const_names))
