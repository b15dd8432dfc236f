"""kernelcheck: a compute-sanitizer-style analyzer for the port's
:class:`~repro_torch.core.kernel.KernelDef`.

The runtime *trusts* every kernel declaration: ``reads`` becomes graph
hazard-DAG edges, ``combines`` decides whether a cross-device merge is
exact, and ``donates`` re-binds handles in place.  A wrong declaration
silently corrupts replay ordering or aliased storage - the same way an
undetected data race corrupts a CUDA kernel.  NVIDIA ships
``compute-sanitizer`` (racecheck/memcheck) for the latter; this module is
the port's analogue for both, the counterpart of ``repro.core.analyze``.

It is an *abstract interpreter over the concrete semantics*: each stage
runs eagerly under the vector lowering's thread model (``tid =
arange(block_size)``, one chunk = the whole block) on the device the
buffers lie on, with every shared/global buffer wrapped in a
:class:`TrackedArray` that records which thread touched which element.
The stage bodies compute on the buffers' device; only the bookkeeping
(footprints, changed locations, per-thread tables) is NumPy on the host.
Because stages are barrier-delimited (a stage boundary is a
``__syncthreads``), the recorded per-stage access tables support exactly
the checks compute-sanitizer performs dynamically, plus one it cannot:

* **shared-race** - two threads touch the same __shared__ element inside
  one stage with at least one *changing* write (racecheck).  Writes that
  store the value already present are the IR's masked-write idiom
  (``where(cond, new, old)`` + unconditional scatter) and are not races.
* **oob-write** - a scatter past the end of a buffer whose author did not
  ask for the drop (``index.put(..., drop=False)``; memcheck).
  Out-of-range *reads* are defined IR semantics (JAX's gather clamps) and
  are never flagged.
* **declaration audit** - observed global reads/writes/atomic kinds vs the
  declared ``reads``/``writes``/``combines``, with suggested corrections.
  A scatter into a buffer implies a read (unwritten elements carry
  through), so written buffers must appear in ``reads``.
* **donation-hazard** - a ``donates``-declared buffer read in a stage
  *after* one that overwrote it: the read observes partially-updated
  storage once the buffer is updated in place.
* **fusion verdicts** - for every adjacent stage pair, a proof attempt
  that no cross-thread dependence flows through shared or global memory,
  i.e. the ``__syncthreads`` between them is removable.  The
  barrier-fission optimizer (:mod:`repro_torch.core.optimize`) consumes
  them.

A stage reaches its buffers in four ways, and :class:`TrackedArray`
records each: gathers through :func:`repro_torch.core.index.take` reach
its ``__getitem__``; scatters through :func:`repro_torch.core.index.put`
reach its ``tracked_put``; ``Ctx.atomic_*`` calls reach
:class:`AnalyzeCtx`; any other torch call (``torch.where``, arithmetic,
``.clone()``) reaches its ``__torch_function__`` and reads the whole
buffer.

Entry points: :func:`analyze_kernel` / :func:`analyze_entry` /
:func:`analyze_suite` for programmatic use, ``python -m
repro_torch.core.analyze`` as the gate (``--inject-*`` flags plant known
bugs to prove the gate trips), and :func:`sanitize_launch` behind
``launch(..., sanitize=True)`` / ``CUPBOP_SANITIZE=1`` on the api path.
The entry points run on the card unless the caller passes
``device="cpu"``.

The analyzer samples a handful of blocks (first / middle / last) rather
than the whole grid: access *patterns* are block-position-dependent only
through boundary masks, which the sample covers.  Findings are therefore
sound bug reports ("this access happened"), while clean verdicts and
fusion proofs hold for the sampled blocks' concrete inputs - the usual
dynamic-tool contract.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import operator
import sys
from typing import Sequence

import numpy as np
import torch

from repro_torch import carry
from repro_torch.core import api, atomics, index, memory
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import BlockState, Ctx, KernelDef, check_priv_chunk

__all__ = [
    "FINDING_KINDS", "FUSION_SCHEMA", "Finding", "FusionVerdict",
    "KernelReport", "SanitizerError", "TrackedArray", "analyze_entry",
    "analyze_fusion", "analyze_kernel", "analyze_suite", "fusion_entry",
    "fusion_suite", "fusion_to_json", "main", "report_to_json",
    "sanitize_env_enabled", "sanitize_launch",
]

ALL = -1  # sentinel thread id: "every thread in the block"

FINDING_KINDS = (
    "shared-race", "oob-write", "undeclared-read", "unused-read",
    "missing-reads", "undeclared-write", "unobserved-write",
    "combine-mismatch", "incomplete-combines", "donation-hazard",
)

# accum kinds observed at runtime that contradict a declared cross-shard
# combine mode (e.g. atomicMax into a buffer declared combines="sum")
_COMBINE_CONTRA = {
    "sum": {"max", "min"},
    "max": {"add", "min"},
    "min": {"add", "max"},
    "concat": {"add", "max", "min"},
}
_KIND_TO_MODE = {"add": "sum", "max": "max", "min": "min"}


class SanitizerError(Exception):
    """Raised by a ``sanitize=True`` launch whose kernel has findings."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One sanitizer diagnostic, anchored to kernel/stage/buffer."""

    kind: str            # one of FINDING_KINDS
    kernel: str
    buffer: str
    stage: int | None    # None for whole-kernel (declaration) findings
    detail: str
    suggestion: str | None = None

    def __str__(self):
        where = self.kernel if self.stage is None \
            else f"{self.kernel} stage {self.stage}"
        msg = f"[{self.kind}] {where} / {self.buffer}: {self.detail}"
        if self.suggestion:
            msg += f"  (suggest: {self.suggestion})"
        return msg


@dataclasses.dataclass(frozen=True)
class FusionVerdict:
    """Mergeability of one adjacent stage pair (barrier-removal proof)."""

    kernel: str
    pair: tuple[int, int]
    mergeable: bool
    reason: str

    def __str__(self):
        tag = "mergeable" if self.mergeable else "kept"
        return (f"{self.kernel} stages {self.pair[0]}->{self.pair[1]}: "
                f"{tag} ({self.reason})")


@dataclasses.dataclass
class KernelReport:
    """Everything kernelcheck learned about one kernel at one geometry."""

    kernel: str
    grid: Dim3
    block: Dim3
    blocks_analyzed: tuple[int, ...]
    findings: list[Finding]
    fusion: list[FusionVerdict]

    @property
    def clean(self) -> bool:
        return not self.findings

    @property
    def n_mergeable(self) -> int:
        return sum(v.mergeable for v in self.fusion)


# --------------------------------------------------------------------------
# Access recording: per-buffer, per-stage tables of who touched what.
# --------------------------------------------------------------------------
class _StageAcc:
    """Access table for one buffer during one stage (barrier interval)."""

    __slots__ = ("reads", "writes", "accums", "touched", "read_all",
                 "whole_write", "read_ops", "write_ops", "accum_ops",
                 "accum_kinds", "oob")

    def __init__(self):
        self.reads: dict[int, set] = {}    # flat loc -> thread ids
        self.writes: dict[int, set] = {}   # value-changing writes only
        self.accums: dict[int, set] = {}   # value-changing accumulations
        self.touched: dict[int, set] = {}  # ALL attempted writes/accums
        self.read_all = False              # whole buffer read by all threads
        self.whole_write = False           # opaque rebind: assume all written
        self.read_ops = 0
        self.write_ops = 0
        self.accum_ops = 0
        self.accum_kinds: set[str] = set()
        self.oob = 0                       # flagged (not asked-for) drops

    def touched_write(self) -> bool:
        return bool(self.touched or self.writes or self.accums
                    or self.whole_write)


class _BufRec:
    """Recorder for one buffer across the stages of one analyzed block."""

    __slots__ = ("name", "space", "shape", "chunk", "stages")

    def __init__(self, name: str, space: str, shape, chunk: int):
        self.name = name
        self.space = space            # "shared" | "glob"
        self.shape = tuple(int(d) for d in shape)
        self.chunk = chunk
        self.stages: list[_StageAcc] = []

    @property
    def cur(self) -> _StageAcc:
        return self.stages[-1]

    def begin_stage(self):
        self.stages.append(_StageAcc())

    # -- event recording ----------------------------------------------------
    def record_read_all(self):
        self.cur.read_ops += 1
        self.cur.read_all = True

    def record_read(self, fp: "_Footprint"):
        self.cur.read_ops += 1
        if fp.whole:
            self.cur.read_all = True
            return
        _merge(self.cur.reads, fp.locs)

    def record_write(self, fp: "_Footprint", changed, *, dropped: bool):
        self.cur.write_ops += 1
        if not dropped:
            self.cur.oob += fp.oob
        if fp.whole:
            self.cur.whole_write = True
            return
        _merge(self.cur.writes, fp.locs, keep=changed)
        _merge(self.cur.touched, fp.locs)

    def record_accum(self, kind: str, fp: "_Footprint", changed, *,
                     dropped: bool):
        self.cur.accum_ops += 1
        self.cur.accum_kinds.add(kind)
        if not dropped:
            self.cur.oob += fp.oob
        if fp.whole:
            self.cur.whole_write = True
            return
        _merge(self.cur.accums, fp.locs, keep=changed)
        _merge(self.cur.touched, fp.locs)

    def record_opaque_write(self):
        """A stage rebound this buffer to an untracked tensor."""
        self.cur.write_ops += 1
        self.cur.whole_write = True


def _merge(table: dict, locs: dict, keep: set | None = None) -> None:
    """Add each thread's locations to ``table`` (flat loc -> thread ids);
    with ``keep``, only the locations in it (those whose stored value
    actually changed)."""
    for tid, flat in locs.items():
        for loc in flat:
            if keep is None or loc in keep:
                table.setdefault(loc, set()).add(tid)


def _changed_locs(old: torch.Tensor, new: torch.Tensor) -> set:
    """Flat locations where the scatter changed the stored value.

    Compared on the tensors' device; only the locations reach the host.
    NaN-stable: writing NaN over NaN is a no-op, not a change."""
    diff = old != new
    if old.is_floating_point():
        diff &= ~(torch.isnan(old) & torch.isnan(new))
    return set(torch.nonzero(diff.reshape(-1)).reshape(-1).tolist())


# --------------------------------------------------------------------------
# Index classification: an indexing key -> per-thread flat locations.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Footprint:
    whole: bool               # conservative: every thread, every element
    locs: dict                # thread id (or ALL) -> flat locs (ints)
    oob: int                  # out-of-range positions (after neg wrapping)


def _host_index(k):
    """An index component as a NumPy array (a tensor's host copy)."""
    if isinstance(k, TrackedArray):
        k = k.value
    if isinstance(k, torch.Tensor):
        return k.detach().cpu().numpy()
    return np.asarray(k)


def _footprint(key, shape, chunk: int, *, clamp: bool) -> _Footprint:
    """Classify ``arr[key]`` under the vector thread model.

    A 1-D integer array of length ``chunk`` is a per-thread index (thread
    ``t`` supplies element ``t``); ints and slices are uniform across the
    block.  ``clamp=True`` is gather semantics (out-of-range clamps to the
    edge, JAX's rule that the suite relies on); ``clamp=False`` is scatter
    semantics (out-of-range drops, and is *counted* so callers can flag
    drops the author did not ask for).  Anything unrecognized (boolean
    masks, >1-D index arrays) degrades to a whole-buffer footprint.
    """
    if not isinstance(key, tuple):
        key = (key,)
    if len(key) > len(shape):
        return _Footprint(True, {}, 0)
    key = key + (slice(None),) * (len(shape) - len(key))

    per_axis = []  # ("all", values) | ("thr", per-thread values)
    for k, size in zip(key, shape, strict=True):
        if isinstance(k, slice):
            per_axis.append(("all", np.arange(*k.indices(size)), size))
            continue
        try:
            arr = _host_index(k)
        except (TypeError, ValueError, RuntimeError):
            return _Footprint(True, {}, 0)
        if arr.dtype.kind not in "iu":
            return _Footprint(True, {}, 0)
        if arr.ndim == 0:
            per_axis.append(("all", arr.reshape(1), size))
        elif arr.ndim == 1 and arr.shape[0] == chunk:
            per_axis.append(("thr", arr, size))
        else:
            return _Footprint(True, {}, 0)

    # numpy-style negative wrapping, then bounds handling per semantics
    oob = 0

    def fix(vals, size):
        vals = np.where(vals < 0, vals + size, vals)
        bad = (vals < 0) | (vals >= size)
        if clamp:
            return np.clip(vals, 0, size - 1), np.zeros_like(bad)
        return vals, bad

    fixed = []
    for kind, vals, size in per_axis:
        vals, bad = fix(vals, size)
        fixed.append((kind, vals, bad, size))

    sizes = [size for _, _, _, size in fixed]
    if not any(kind == "thr" for kind, _, _, _ in fixed):
        # uniform footprint: cartesian product, accessed by every thread
        grids = np.meshgrid(*[v for _, v, _, _ in fixed], indexing="ij")
        bads = np.meshgrid(*[b for _, _, b, _ in fixed], indexing="ij")
        ok = ~np.logical_or.reduce([b.ravel() for b in bads])
        flat = np.ravel_multi_index(
            [g.ravel()[ok] for g in grids], sizes) if ok.any() else \
            np.empty(0, np.int64)
        oob = int((~ok).sum())
        return _Footprint(False, {ALL: flat.tolist()} if flat.size else {},
                          oob)

    # per-thread footprint
    if all(v.size == 1 or kind == "thr" for kind, v, _, _ in fixed):
        # fast path: exactly one location per thread
        coords, bad = [], np.zeros(chunk, bool)
        for kind, vals, b, _ in fixed:
            if kind == "thr":
                coords.append(vals)
                bad |= b
            else:
                coords.append(np.full(chunk, vals[0]))
                bad |= bool(b[0])
        ok = ~bad
        flat = np.ravel_multi_index([c[ok] for c in coords], sizes)
        locs = {t: (loc,) for t, loc in zip(np.flatnonzero(ok).tolist(),
                                            flat.tolist(), strict=True)}
        return _Footprint(False, locs, int(bad.sum()))

    # general: per-thread loop over the mixed thr x range footprint
    locs = {}
    for t in range(chunk):
        axes, dead = [], False
        for kind, vals, b, _ in fixed:
            if kind == "thr":
                if b[t]:
                    oob += 1
                    dead = True
                    break
                axes.append(vals[t:t + 1])
            else:
                keep = ~b
                oob += int(b.sum()) if t == 0 else 0
                axes.append(vals[keep])
        if dead or any(a.size == 0 for a in axes):
            continue
        grids = np.meshgrid(*axes, indexing="ij")
        locs[t] = np.ravel_multi_index([g.ravel() for g in grids],
                                       sizes).tolist()
    return _Footprint(False, locs, oob)


# --------------------------------------------------------------------------
# TrackedArray: the instrumented buffer handed to stage bodies.
# --------------------------------------------------------------------------
def _unwrap(v):
    return v._value if isinstance(v, TrackedArray) else v


def _unwrap_reading(v):
    """Unwrap tracked buffers anywhere in ``v`` (a tree of lists, tuples
    and dicts), recording a whole-buffer read for each."""
    if isinstance(v, TrackedArray):
        v._rec.record_read_all()
        return v._value
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap_reading(x) for x in v)
    if isinstance(v, dict):
        return {k: _unwrap_reading(x) for k, x in v.items()}
    return v


class TrackedArray:
    """Tensor proxy that records per-thread element accesses.

    Reads (``index.take``, which indexes it, any torch call through
    ``__torch_function__``, arithmetic, tensor methods) return *plain*
    tensors - tracking applies to the buffer itself, not to values
    derived from it.  Scatters (``index.put``, ``ctx.atomic_*``) return a
    new ``TrackedArray`` sharing the recorder, so the functional update
    chain inside a stage stays instrumented.
    """

    __array_priority__ = 200  # win reflected ops against numpy operands
    __slots__ = ("_value", "_rec")

    def __init__(self, value: torch.Tensor, rec: _BufRec):
        self._value = value
        self._rec = rec

    # -- introspection (metadata: no access) --------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def shape(self):
        return self._value.shape

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def device(self):
        return self._value.device

    @property
    def ndim(self):
        return self._value.ndim

    def dim(self) -> int:
        return self._value.dim()

    def size(self, *dim):
        return self._value.size(*dim)

    def numel(self) -> int:
        return self._value.numel()

    def is_floating_point(self) -> bool:
        return self._value.is_floating_point()

    def __len__(self):
        return len(self._value)

    def __repr__(self):
        return f"TrackedArray({self._rec.space}:{self._rec.name})"

    # -- reads --------------------------------------------------------------
    def __getitem__(self, key):
        fp = _footprint(key, self._rec.shape, self._rec.chunk, clamp=True)
        self._rec.record_read(fp)
        return self._value[_unwrap(key) if not isinstance(key, tuple)
                           else tuple(_unwrap(k) for k in key)]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # any other torch call consumes the whole buffer on behalf of all
        # threads
        return func(*_unwrap_reading(tuple(args)),
                    **_unwrap_reading(kwargs or {}))

    def __array__(self, dtype=None, copy=None):
        self._rec.record_read_all()
        return np.asarray(self._value.detach().cpu().numpy(), dtype=dtype)

    def __getattr__(self, name):
        # tensor methods (.clone(), .float(), .sum(), ...) read the whole
        # buffer; private names are never forwarded
        if name.startswith("_"):
            raise AttributeError(name)
        self._rec.record_read_all()
        return getattr(self._value, name)

    # -- writes -------------------------------------------------------------
    def tracked_put(self, idx, val, op: str, *, drop: bool):
        """``index.put`` on the tracked buffer: the attempted footprint,
        the changed locations and whether the drop was asked for."""
        rec = self._rec
        old = self._value
        new = index.put(old, idx, _unwrap(val), op)
        fp = _footprint(idx, rec.shape, rec.chunk, clamp=False)
        changed = _changed_locs(old, new)
        if op == "set":
            rec.record_write(fp, changed, dropped=drop)
        else:
            rec.record_accum(op, fp, changed, dropped=drop)
        return TrackedArray(new, rec)


def _binop(name, reflected=False):
    fn = getattr(operator, name)

    def op(self, other):
        self._rec.record_read_all()
        a, b = self._value, _unwrap(other)
        return fn(b, a) if reflected else fn(a, b)
    return op


def _unop(name):
    fn = getattr(operator, name)

    def op(self):
        self._rec.record_read_all()
        return fn(self._value)
    return op


for _n in ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow",
           "and", "or", "xor", "lshift", "rshift", "matmul"):
    setattr(TrackedArray, f"__{_n}__", _binop(f"__{_n}__"))
    setattr(TrackedArray, f"__r{_n}__", _binop(f"__{_n}__", reflected=True))
for _n in ("lt", "le", "gt", "ge", "eq", "ne"):
    setattr(TrackedArray, f"__{_n}__", _binop(f"__{_n}__"))
for _n in ("neg", "pos", "abs", "invert"):
    setattr(TrackedArray, f"__{_n}__", _unop(f"__{_n}__"))


class AnalyzeCtx(Ctx):
    """A :class:`Ctx` whose atomics record accesses before delegating."""

    def _atomic(self, kind: str, arr, idx, fn, *rest):
        if not isinstance(arr, TrackedArray):
            return fn(arr, idx, *rest)
        rec = arr._rec
        old = arr._value
        res = fn(old, idx, *[_unwrap(r) for r in rest])
        new, ret = res if isinstance(res, tuple) else (res, None)
        fp = _footprint(idx, rec.shape, rec.chunk, clamp=False)
        if ret is not None:
            # CAS/exchange return the prior value: an explicit read
            rec.record_read(dataclasses.replace(fp, oob=0))
        rec.record_accum(kind, fp, _changed_locs(old, new), dropped=True)
        wrapped = TrackedArray(new, rec)
        return wrapped if ret is None else (wrapped, ret)

    def atomic_add(self, arr, idx, val):
        return self._atomic("add", arr, idx, atomics.atomic_add, val)

    def atomic_max(self, arr, idx, val):
        return self._atomic("max", arr, idx, atomics.atomic_max, val)

    def atomic_min(self, arr, idx, val):
        return self._atomic("min", arr, idx, atomics.atomic_min, val)

    def atomic_cas(self, arr, idx, cmp, val):
        return self._atomic("cas", arr, idx, atomics.atomic_cas, cmp, val)

    def atomic_exch(self, arr, idx, val):
        return self._atomic("exch", arr, idx, atomics.atomic_exch, val)

    def atomic_cas_first(self, arr, idx, cmp, val):
        return self._atomic("cas", arr, idx, atomics.atomic_cas_first,
                            cmp, val)


# --------------------------------------------------------------------------
# Block interpretation.
# --------------------------------------------------------------------------
def _device(glob: dict) -> torch.device:
    return next(iter(glob.values())).device if glob else torch.device("cpu")


def _interpret_block(kernel: KernelDef, bid: int, *, block: Dim3, grid: Dim3,
                     glob: dict, dyn_shared):
    """Run every stage of block ``bid`` eagerly under instrumentation, on
    the device the buffers lie on."""
    recs: dict[str, _BufRec] = {}
    device = _device(glob)

    def wrap(space, bufs):
        out = {}
        for name, v in bufs.items():
            rec = _BufRec(name, space, v.shape, block.size)
            recs[name] = rec
            out[name] = TrackedArray(v, rec)
        return out

    st = BlockState(priv={},
                    shared=wrap("shared",
                                kernel.init_shared(dyn_shared, device)),
                    glob=wrap("glob", glob))
    ctx = AnalyzeCtx(
        bid=bid, tid=torch.arange(block.size, dtype=torch.int32,
                                  device=device),
        block_dim=block.size, grid_dim=grid.size, backend="vector",
        uses_warp=True, block_dim3=block, grid_dim3=grid)

    n_stages = len(kernel.stages)
    for si, stage in enumerate(kernel.stages):
        for rec in recs.values():
            rec.begin_stage()
        st = stage(ctx, st)
        check_priv_chunk(st.priv, block.size, kernel.name, si)
        st = st._replace(shared=_rewrap("shared", st.shared, recs, block, si),
                         glob=_rewrap("glob", st.glob, recs, block, si))
    for rec in recs.values():
        while len(rec.stages) < n_stages:
            rec.begin_stage()
    out = {n: _unwrap(v) for n, v in st.glob.items()}
    return recs, out


def _rewrap(space, bufs, recs, block, si):
    """Re-instrument buffers a stage rebound to plain (untracked) tensors."""
    out = {}
    for name, v in bufs.items():
        if isinstance(v, TrackedArray):
            out[name] = v
            continue
        v = torch.as_tensor(v)
        rec = recs.get(name)
        if rec is None:
            rec = _BufRec(name, space, v.shape, block.size)
            recs[name] = rec
            for _ in range(si + 1):
                rec.begin_stage()
        rec.record_opaque_write()
        out[name] = TrackedArray(v, rec)
    return out


def _sample_bids(grid_size: int, n: int) -> tuple[int, ...]:
    n = max(1, min(n, grid_size))
    if n == 1:
        return (0,)
    step = (grid_size - 1) / (n - 1)
    return tuple(sorted({int(round(i * step)) for i in range(n)}))


def _raw_args(args: dict, op: str) -> dict:
    """The launch's buffers as plain tensors (handles unwrapped)."""
    return {n: memory.unwrap(v, op) for n, v in args.items()}


def _interpret(kernel: KernelDef, grid: Dim3, block: Dim3, glob: dict,
               dyn_shared, sample_blocks: int):
    """Interpret the sampled blocks in order, each seeing the buffers the
    ones before it left; returns (block ids, [(bid, recorders)])."""
    bids = _sample_bids(grid.size, sample_blocks)
    per_block = []
    _CONCAT_EXTENTS[id(kernel)] = {
        n: int(v.shape[0]) for n, v in glob.items() if v.ndim}
    try:
        for bid in bids:
            recs, glob = _interpret_block(kernel, bid, block=block,
                                          grid=grid, glob=glob,
                                          dyn_shared=dyn_shared)
            per_block.append((bid, recs))
    except BaseException:
        _CONCAT_EXTENTS.pop(id(kernel), None)
        raise
    return bids, per_block


# --------------------------------------------------------------------------
# Checks over the recorded tables.
# --------------------------------------------------------------------------
def _cross(a: set, b: set, block_size: int) -> bool:
    """Do two access-thread sets contain a pair of *distinct* threads?"""
    if not a or not b or block_size <= 1:
        return False
    if ALL in a or ALL in b:
        return True
    return len(a | b) > 1


def _fmt_loc(loc: int, shape) -> str:
    if len(shape) <= 1:
        return str(loc)
    return str(tuple(int(c) for c in np.unravel_index(loc, shape)))


def _stage_races(acc: _StageAcc, block_size: int):
    """Yield (description, flat loc) for every race inside one stage."""
    if acc.whole_write and block_size > 1:
        yield "opaque whole-buffer rebind (unanalyzable write)", 0
        return
    for loc, writers in acc.writes.items():
        if len(writers) > 1 or (ALL in writers and block_size > 1):
            yield "write-write between threads", loc
    if acc.read_all and block_size > 1 and (acc.writes or acc.accums):
        loc = next(iter(acc.writes or acc.accums))
        yield "whole-buffer read concurrent with writes", loc
        return
    for loc, readers in acc.reads.items():
        writers = acc.writes.get(loc, set())
        if _cross(readers, writers, block_size):
            yield "read-write between threads", loc
    for loc, accums in acc.accums.items():
        others = acc.writes.get(loc, set()) | acc.reads.get(loc, set())
        if _cross(accums, others, block_size):
            yield "atomic update concurrent with plain access", loc


def _race_findings(kernel, per_block, block_size):
    out, seen = [], set()
    for bid, recs in per_block:
        for rec in recs.values():
            if rec.space != "shared":
                continue
            for si, acc in enumerate(rec.stages):
                for desc, loc in _stage_races(acc, block_size):
                    key = (si, rec.name, desc)
                    if key in seen:
                        continue
                    seen.add(key)
                    out.append(Finding(
                        kind="shared-race", kernel=kernel.name,
                        buffer=rec.name, stage=si,
                        detail=(f"block {bid}: {desc} at "
                                f"{rec.name}[{_fmt_loc(loc, rec.shape)}] "
                                f"with no intervening __syncthreads"),
                        suggestion="split the racing accesses across a "
                                   "stage boundary"))
    return out


def _oob_findings(kernel, per_block):
    out, seen = [], set()
    for bid, recs in per_block:
        for rec in recs.values():
            for si, acc in enumerate(rec.stages):
                if not acc.oob or (si, rec.name) in seen:
                    continue
                seen.add((si, rec.name))
                out.append(Finding(
                    kind="oob-write", kernel=kernel.name, buffer=rec.name,
                    stage=si,
                    detail=(f"block {bid}: {acc.oob} scatter position(s) "
                            f"past the end of {rec.name}{rec.shape} "
                            f"without mode=\"drop\""),
                    suggestion="mask the index (OOB sentinel) and pass "
                               "mode=\"drop\" explicitly"))
    return out


def _glob_observations(per_block):
    """Aggregate global-buffer observations across analyzed blocks."""
    read = set()
    written = set()
    kinds: dict[str, set] = {}
    rows: dict[str, dict[int, set]] = {}
    for bid, recs in per_block:
        for rec in recs.values():
            if rec.space != "glob":
                continue
            for acc in rec.stages:
                if acc.read_ops:
                    read.add(rec.name)
                if acc.write_ops or acc.accum_ops:
                    written.add(rec.name)
                kinds.setdefault(rec.name, set()).update(acc.accum_kinds)
                if rec.shape:
                    tgt = rows.setdefault(rec.name, {}).setdefault(bid, set())
                    stride = int(np.prod(rec.shape[1:], dtype=np.int64))
                    for loc in (*acc.writes, *acc.accums):
                        tgt.add(loc // stride)
    return read, written, kinds, rows


def _audit_findings(kernel: KernelDef, per_block, grid: Dim3, bids):
    out = []
    read, written, kinds, rows = _glob_observations(per_block)
    declared_w = set(kernel.writes)

    for name in sorted(written - declared_w):
        out.append(Finding(
            kind="undeclared-write", kernel=kernel.name, buffer=name,
            stage=None,
            detail=f"kernel writes {name} but does not declare it",
            suggestion=f"writes={tuple(sorted(declared_w | {name}))!r}"))
    for name in sorted(declared_w - written):
        out.append(Finding(
            kind="unobserved-write", kernel=kernel.name, buffer=name,
            stage=None,
            detail=(f"declared write {name} never observed in analyzed "
                    f"blocks {list(bids)}"),
            suggestion=f"writes={tuple(sorted(declared_w & written))!r}"))

    # a scatter implies a read: unwritten elements carry through, so every
    # written buffer needs a reads edge for the hazard DAG to be complete
    required = read | written
    if kernel.reads is None:
        out.append(Finding(
            kind="missing-reads", kernel=kernel.name, buffer="*", stage=None,
            detail="reads is None (conservative whole-heap ordering); "
                   "observed read set is known",
            suggestion=f"reads={tuple(sorted(required))!r}"))
    else:
        declared_r = set(kernel.reads)
        for name in sorted(required - declared_r):
            why = "reads" if name in read else \
                "scatter-writes (unwritten elements carry through)"
            out.append(Finding(
                kind="undeclared-read", kernel=kernel.name, buffer=name,
                stage=None,
                detail=f"kernel {why} {name} but reads omits it",
                suggestion=f"reads={tuple(sorted(declared_r | {name}))!r}"))
        for name in sorted(declared_r - required):
            out.append(Finding(
                kind="unused-read", kernel=kernel.name, buffer=name,
                stage=None,
                detail=(f"declared read {name} never touched in analyzed "
                        f"blocks {list(bids)}"),
                suggestion=f"reads={tuple(sorted(declared_r & required))!r}"))

    out.extend(_combine_findings(kernel, written, kinds, rows, grid))
    return out


def _combine_findings(kernel, written, kinds, rows, grid: Dim3):
    out = []
    if kernel.combines:
        for name in sorted(set(kernel.writes) - set(kernel.combines)):
            out.append(Finding(
                kind="incomplete-combines", kernel=kernel.name, buffer=name,
                stage=None,
                detail=("combines declared for some written buffers but "
                        f"not {name}; the shard backend needs all or none"),
                suggestion=f'combines={{..., "{name}": "sum"}}'))
    for name, mode in sorted(kernel.combines.items()):
        observed = kinds.get(name, set())
        contra = observed & _COMBINE_CONTRA.get(mode, set())
        if contra:
            want = {_KIND_TO_MODE[k] for k in contra if k in _KIND_TO_MODE}
            sugg = f'combines={{"{name}": "{min(want)}"}}' if want \
                else None
            out.append(Finding(
                kind="combine-mismatch", kernel=kernel.name, buffer=name,
                stage=None,
                detail=(f"declared cross-shard combine \"{mode}\" but "
                        f"observed atomic {sorted(contra)} updates"),
                suggestion=sugg))
        if mode == "concat":
            out.extend(_concat_ownership(kernel, name, rows.get(name, {}),
                                         grid))
    return out


def _concat_ownership(kernel, name, rows_by_bid, grid: Dim3):
    """``concat`` claims block ``b`` writes only rows [b*rpb, (b+1)*rpb)."""
    out = []
    extent = _CONCAT_EXTENTS.get(id(kernel), {}).get(name)
    if extent is None or grid.size == 0 or extent % grid.size != 0:
        return out
    rpb = extent // grid.size
    for bid, touched in sorted(rows_by_bid.items()):
        lo, hi = bid * rpb, (bid + 1) * rpb
        stray = {r for r in touched if not lo <= r < hi}
        if stray:
            out.append(Finding(
                kind="combine-mismatch", kernel=kernel.name, buffer=name,
                stage=None,
                detail=(f"combines=\"concat\" but block {bid} wrote rows "
                        f"{sorted(stray)[:4]} outside its owned slice "
                        f"[{lo}, {hi})"),
                suggestion=f'combines={{"{name}": "sum"}}'))
            break
    return out


# concat ownership needs each buffer's leading extent; recorded here per
# analysis run (keyed by kernel identity) instead of threading it through
# every check signature
_CONCAT_EXTENTS: dict[int, dict[str, int]] = {}


def _donation_findings(kernel: KernelDef, per_block):
    out = []
    for name in kernel.donates:
        for bid, recs in per_block:
            rec = recs.get(name)
            if rec is None:
                continue
            first_write = None
            for si, acc in enumerate(rec.stages):
                if first_write is not None and acc.read_ops:
                    out.append(Finding(
                        kind="donation-hazard", kernel=kernel.name,
                        buffer=name, stage=si,
                        detail=(f"block {bid}: donated buffer {name} is "
                                f"overwritten in stage {first_write} and "
                                f"read again in stage {si}; once XLA "
                                f"aliases the storage the read observes "
                                f"partially-updated data"),
                        suggestion="read before overwriting, or drop "
                                   f"{name!r} from donates"))
                    break
                if first_write is None and acc.touched_write():
                    first_write = si
            else:
                continue
            break
    return out


def _pair_dep(rec: _BufRec, a: _StageAcc, b: _StageAcc,
              block_size: int) -> str | None:
    """Cross-thread dependence carried by ``rec`` from stage a to b.

    Ordering uses the *attempted* write footprints (``touched``), not the
    value-changing ones: a write that happened to store an unchanged value
    under the sample inputs still orders against other threads in general,
    and a fusion proof built from value diffs would be unsound (e.g. an
    argmin tree level that keeps its value on the sampled data but swaps
    on real data)."""
    if a.whole_write or b.whole_write:
        if (a.touched_write() or a.read_ops) and \
                (b.touched_write() or b.read_ops) and block_size > 1:
            return "opaque whole-buffer write"
    a_w = {loc: (a.touched.get(loc, set()) | a.writes.get(loc, set())
                 | a.accums.get(loc, set()))
           for loc in (*a.touched, *a.writes, *a.accums)}
    b_w = {loc: (b.touched.get(loc, set()) | b.writes.get(loc, set())
                 | b.accums.get(loc, set()))
           for loc in (*b.touched, *b.writes, *b.accums)}
    if a_w and b.read_all and block_size > 1:
        return "written then read whole-buffer by all threads"
    if b_w and a.read_all and block_size > 1:
        return "read whole-buffer then overwritten"
    for loc, writers in a_w.items():
        if _cross(writers, b.reads.get(loc, set()), block_size):
            return (f"element {_fmt_loc(loc, rec.shape)} written then read "
                    f"by a different thread")
        if _cross(writers, b_w.get(loc, set()), block_size):
            return (f"element {_fmt_loc(loc, rec.shape)} written by "
                    f"different threads across the pair")
    for loc, writers in b_w.items():
        if _cross(a.reads.get(loc, set()), writers, block_size):
            return (f"element {_fmt_loc(loc, rec.shape)} read then "
                    f"overwritten by a different thread")
    return None


_CLEAN_REASON = ("no cross-thread dependence through shared or "
                 "global memory in any analyzed block")


def _pair_verdict(kernel: KernelDef, per_block, block_size: int,
                  i: int, j: int) -> FusionVerdict:
    """Verdict for one (not necessarily adjacent) stage pair ``i < j``."""
    reason = None
    for bid, recs in per_block:
        for rec in recs.values():
            dep = _pair_dep(rec, rec.stages[i], rec.stages[j], block_size)
            if dep:
                reason = f"block {bid}, {rec.space} {rec.name}: {dep}"
                break
        if reason:
            break
    return FusionVerdict(
        kernel=kernel.name, pair=(i, j), mergeable=reason is None,
        reason=reason or _CLEAN_REASON)


def _fusion_verdicts(kernel: KernelDef, per_block, block_size: int):
    return [_pair_verdict(kernel, per_block, block_size, i, i + 1)
            for i in range(len(kernel.stages) - 1)]


def _shared_facts(per_block) -> dict:
    """Per-__shared__-buffer facts for the optimizer's scalarization and
    carried-state elision: which stages touch the buffer, and whether every
    element is only ever touched by a single thread (``private``) - privacy
    is a within-block property, so different blocks may own a cell through
    different threads without breaking it."""
    state: dict[str, dict] = {}
    for _bid, recs in per_block:
        for rec in recs.values():
            if rec.space != "shared":
                continue
            fs = state.setdefault(rec.name, {"stages": set(),
                                             "private": True})
            owner: dict[int, int] = {}
            for si, acc in enumerate(rec.stages):
                if acc.read_ops or acc.write_ops or acc.accum_ops:
                    fs["stages"].add(si)
                if acc.read_all or acc.whole_write:
                    fs["private"] = False
                    continue
                # privacy must see attempted (touched) writes too: a no-op
                # write by another thread still disqualifies scalarization
                for table in (acc.reads, acc.writes, acc.accums,
                              acc.touched):
                    for loc, tids in table.items():
                        if ALL in tids or len(tids) > 1:
                            fs["private"] = False
                            continue
                        t = next(iter(tids))
                        if owner.setdefault(loc, t) != t:
                            fs["private"] = False
    return {
        name: {
            "stages": sorted(fs["stages"]),
            "last_stage": max(fs["stages"]) if fs["stages"] else None,
            "private": bool(fs["stages"]) and fs["private"],
        }
        for name, fs in sorted(state.items())
    }


# --------------------------------------------------------------------------
# Public analysis entry points.
# --------------------------------------------------------------------------
def analyze_kernel(kernel: KernelDef, *, grid, block, args: dict,
                   dyn_shared: int | None = None,
                   sample_blocks: int = 3) -> KernelReport:
    """Run kernelcheck on one kernel at one launch geometry.

    ``args`` are representative global buffers (tensors; handles are
    unwrapped), analyzed on the device they lie on; they are consumed
    functionally - the caller's tensors are not mutated.  Returns the
    :class:`KernelReport`; raises nothing on findings (the ``sanitize``
    launch path turns findings into :class:`SanitizerError`).
    """
    grid, block = Dim3.of(grid), Dim3.of(block)
    glob = _raw_args(args, "sanitize")
    bids, per_block = _interpret(kernel, grid, block, glob, dyn_shared,
                                 sample_blocks)
    try:
        findings = []
        findings += _race_findings(kernel, per_block, block.size)
        findings += _oob_findings(kernel, per_block)
        findings += _audit_findings(kernel, per_block, grid, bids)
        findings += _donation_findings(kernel, per_block)
        fusion = _fusion_verdicts(kernel, per_block, block.size)
    finally:
        _CONCAT_EXTENTS.pop(id(kernel), None)
    return KernelReport(kernel=kernel.name, grid=grid, block=block,
                        blocks_analyzed=bids, findings=findings,
                        fusion=fusion)


def _entry_kernels(entry, analyze, *, rng, device) -> list:
    """``analyze(kernel, grid, block, args, dyn_shared)`` for every
    distinct kernel a suite entry launches, on ``device``.

    Chain entries run their steps once in order (no ``prepare`` hooks),
    carrying one real ``vector`` launch's outputs into the next step, so
    later steps (e.g. srad's update consuming the stats kernel's partial
    sums) are analyzed on realistic values."""
    rng = np.random.default_rng(0) if rng is None else rng
    args = carry.from_reference(entry.make_args(rng), device=device)
    if entry.chain is None:
        return [analyze(entry.kernel, entry.grid, entry.block, args,
                        entry.dyn_shared)]
    results, done = [], set()
    for step in entry.chain.steps:
        res = analyze(step.kernel, step.grid, step.block, args,
                      step.dyn_shared)
        if step.kernel.name not in done:
            done.add(step.kernel.name)
            results.append(res)
        args = {**args, **api.launch(step.kernel, grid=step.grid,
                                     block=step.block, args=args,
                                     dyn_shared=step.dyn_shared)}
    return results


def analyze_entry(entry, *, sample_blocks: int = 3, rng=None,
                  device=None) -> list[KernelReport]:
    """Analyze every distinct kernel a suite entry launches, with its
    buffers on ``device`` (the card unless ``"cpu"`` is asked for).

    Chain entries run their steps once in order, carrying the analyzed
    blocks' buffer updates forward so later steps see realistic values.
    """
    def one(kernel, grid, block, args, dyn_shared):
        return analyze_kernel(kernel, grid=grid, block=block, args=args,
                              dyn_shared=dyn_shared,
                              sample_blocks=sample_blocks)
    return _entry_kernels(entry, one, rng=rng, device=device)


def _suite_entries(names, scale: int) -> list:
    from repro_torch.core import cuda_suite   # lazy: cuda_suite imports api
    entries = cuda_suite.build_suite(scale=scale)
    if names:
        wanted = set(names)
        known = [e.name for e in entries]
        entries = [e for e in entries if e.name in wanted]
        missing = wanted - {e.name for e in entries}
        if missing:
            raise ValueError(f"unknown suite entries {sorted(missing)}; "
                             f"known: {known}")
    return entries


def analyze_suite(*, names: Sequence[str] | None = None, scale: int = 1,
                  sample_blocks: int = 3, device=None) -> list[KernelReport]:
    """Run kernelcheck across the CUDA suite (all 23 entries by default)
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    reports = []
    for entry in _suite_entries(names, scale):
        reports.extend(analyze_entry(entry, sample_blocks=sample_blocks,
                                     device=device))
    return reports


def report_to_json(reports: Sequence[KernelReport]) -> dict:
    """JSON-serializable report; ``fusion`` feeds the barrier-fission work."""
    mergeable = [
        {"kernel": v.kernel, "pair": list(v.pair)}
        for r in reports for v in r.fusion if v.mergeable]
    return {
        "schema": 1,
        "kernels": [{
            "kernel": r.kernel,
            "grid": list(r.grid),
            "block": list(r.block),
            "blocks_analyzed": list(r.blocks_analyzed),
            "clean": r.clean,
            "findings": [dataclasses.asdict(f) for f in r.findings],
            "fusion": [{
                "pair": list(v.pair),
                "mergeable": v.mergeable,
                "reason": v.reason,
            } for v in r.fusion],
        } for r in reports],
        "summary": {
            "n_kernels": len(reports),
            "n_findings": sum(len(r.findings) for r in reports),
            "n_stage_pairs": sum(len(r.fusion) for r in reports),
            "n_mergeable": len(mergeable),
            "mergeable_pairs": mergeable,
        },
    }


# --------------------------------------------------------------------------
# Fusion artifact: the stable verdict schema core/optimize.py (and external
# tools via `python -m repro_torch.core.analyze --fusion-only --json`)
# consume.
# --------------------------------------------------------------------------
FUSION_SCHEMA = "kernelcheck-fusion-1"


def analyze_fusion(kernel: KernelDef, *, grid, block, args: dict,
                   dyn_shared: int | None = None,
                   sample_blocks: int = 3) -> dict:
    """Fusion verdicts for one kernel at one geometry, as a stable artifact.

    Schema ``kernelcheck-fusion-1``::

        {"schema": "kernelcheck-fusion-1", "kernel": str,
         "grid": [x, y, z], "block": [x, y, z],
         "blocks_analyzed": [int, ...], "n_stages": int,
         "verdicts": [{"kernel": str, "pair": [i, j],
                       "mergeable": bool, "reason": str}, ...],
         "shared": {name: {"stages": [int, ...], "last_stage": int | null,
                           "private": bool}, ...}}

    ``verdicts`` always covers every *adjacent* pair ``(i, i+1)``.  Within
    each maximal run of mergeable adjacent pairs it additionally carries the
    *skip* pairs ``(p, q), q > p+1``: adjacent proofs alone do not compose
    (a dependence can flow over a stage that never touches the buffer), so
    a multi-stage fused region is only legal when every intra-region pair
    is proven.  ``shared`` feeds scalarization / carried-state elision:
    which stages touch each __shared__ buffer, and whether every element is
    single-thread-private within a block.
    """
    grid, block = Dim3.of(grid), Dim3.of(block)
    glob = _raw_args(args, "fusion analysis")
    bids, per_block = _interpret(kernel, grid, block, glob, dyn_shared,
                                 sample_blocks)
    _CONCAT_EXTENTS.pop(id(kernel), None)
    n = len(kernel.stages)
    verdicts = _fusion_verdicts(kernel, per_block, block.size)
    adj = {v.pair: v.mergeable for v in verdicts}
    i = 0
    while i < n - 1:
        if not adj[(i, i + 1)]:
            i += 1
            continue
        j = i + 1
        while j < n - 1 and adj[(j, j + 1)]:
            j += 1
        for p in range(i, j + 1):
            for q in range(p + 2, j + 1):
                verdicts.append(
                    _pair_verdict(kernel, per_block, block.size, p, q))
        i = j + 1
    return {
        "schema": FUSION_SCHEMA,
        "kernel": kernel.name,
        "grid": list(grid),
        "block": list(block),
        "blocks_analyzed": list(bids),
        "n_stages": n,
        "verdicts": [{"kernel": v.kernel, "pair": list(v.pair),
                      "mergeable": v.mergeable, "reason": v.reason}
                     for v in verdicts],
        "shared": _shared_facts(per_block),
    }


def fusion_entry(entry, *, sample_blocks: int = 3, rng=None,
                 device=None) -> list[dict]:
    """Fusion artifacts for every distinct kernel a suite entry launches,
    with its buffers on ``device`` (the card unless ``"cpu"``).

    Mirrors :func:`analyze_entry`'s chain handling: steps run once in
    order with real launch outputs carried forward, so later steps are
    analyzed on realistic values.
    """
    def one(kernel, grid, block, args, dyn_shared):
        return analyze_fusion(kernel, grid=grid, block=block, args=args,
                              dyn_shared=dyn_shared,
                              sample_blocks=sample_blocks)
    return _entry_kernels(entry, one, rng=rng, device=device)


def fusion_suite(*, names: Sequence[str] | None = None, scale: int = 1,
                 sample_blocks: int = 3, device=None) -> list[dict]:
    """Fusion artifacts across the CUDA suite (all kernels by default) on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    artifacts = []
    for entry in _suite_entries(names, scale):
        artifacts.extend(fusion_entry(entry, sample_blocks=sample_blocks,
                                      device=device))
    return artifacts


def fusion_to_json(artifacts: Sequence[dict]) -> dict:
    """Wrap per-kernel fusion artifacts into the ``--fusion-only`` report."""
    n_adj = sum(
        1 for a in artifacts for v in a["verdicts"]
        if v["pair"][1] - v["pair"][0] == 1)
    n_adj_ok = sum(
        1 for a in artifacts for v in a["verdicts"]
        if v["pair"][1] - v["pair"][0] == 1 and v["mergeable"])
    return {
        "schema": FUSION_SCHEMA,
        "kernels": list(artifacts),
        "summary": {
            "n_kernels": len(artifacts),
            "n_adjacent_pairs": n_adj,
            "n_adjacent_mergeable": n_adj_ok,
        },
    }


# --------------------------------------------------------------------------
# Launch-path hook: sanitize=True / CUPBOP_SANITIZE=1.
# --------------------------------------------------------------------------
_SANITIZE_ATTR = "_kernelcheck_ok"


def sanitize_env_enabled() -> bool:
    return api._sanitize_enabled(None)


def _launch_key(grid: Dim3, block: Dim3, dyn_shared, raw: dict) -> tuple:
    """A launch's memo key: geometry, dyn_shared and buffer shapes."""
    shapes = tuple(sorted((n, tuple(v.shape)) for n, v in raw.items()))
    return (grid, block, dyn_shared, shapes)


def sanitize_launch(kernel: KernelDef, *, grid, block, args: dict,
                    dyn_shared: int | None = None) -> None:
    """Analyze a launch and raise :class:`SanitizerError` on findings.

    Clean verdicts are memoized per (geometry, dyn_shared, buffer shapes)
    on the kernel itself - chain replays and warm launches re-check for
    free, the same lifetime discipline as the launch cache.
    """
    grid, block = Dim3.of(grid), Dim3.of(block)
    key = _launch_key(grid, block, dyn_shared, _raw_args(args, "sanitize"))
    ok = getattr(kernel, _SANITIZE_ATTR, None)
    if ok is None:
        ok = set()
        object.__setattr__(kernel, _SANITIZE_ATTR, ok)  # frozen dataclass
    if key in ok:
        return
    report = analyze_kernel(kernel, grid=grid, block=block, args=args,
                            dyn_shared=dyn_shared)
    if report.findings:
        lines = "\n".join(f"  {f}" for f in report.findings)
        raise SanitizerError(
            f"kernelcheck: {len(report.findings)} finding(s) in kernel "
            f"{kernel.name} (blocks {list(report.blocks_analyzed)} of "
            f"grid {tuple(grid)}):\n{lines}")
    ok.add(key)


# --------------------------------------------------------------------------
# Planted-bug fixtures: the gate's self-tests (and test fodder).  Their
# buffers lie on the CPU; the gate moves them to its device.
# --------------------------------------------------------------------------
def planted_race():
    """Neighbor read racing a same-stage write (classic missing barrier)."""
    def mix(ctx, st):
        s = st.shared["s"]
        v = index.take(s, (ctx.tid + 1) % ctx.block_dim)
        return st.set_shared(s=index.put(s, ctx.tid, v + 1.0))

    def store(ctx, st):
        out = index.put(st.glob["out"], ctx.tid,
                        index.take(st.shared["s"], ctx.tid))
        return st.set_glob(out=out)

    k = KernelDef("planted_race", (mix, store), writes=("out",),
                  reads=("out",), shared={"s": ((32,), torch.float32)})
    return k, 1, 32, {"out": torch.zeros(32, dtype=torch.float32)}


def planted_undeclared_read():
    """Reads a buffer (``bias``) the reads declaration omits."""
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        out = index.put(st.glob["out"], gid,
                        index.take(st.glob["x"], gid)
                        + index.take(st.glob["bias"], 0))
        return st.set_glob(out=out)

    k = KernelDef("planted_undeclared_read", (stage,), writes=("out",),
                  reads=("x", "out"))
    args = {"x": torch.arange(64, dtype=torch.float32),
            "bias": torch.ones(1, dtype=torch.float32),
            "out": torch.zeros(64, dtype=torch.float32)}
    return k, 2, 32, args


def planted_bad_combine():
    """atomicAdd accumulation declared as a cross-shard ``max`` merge."""
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        out = ctx.atomic_add(st.glob["out"], gid % 4,
                             index.take(st.glob["x"], gid))
        return st.set_glob(out=out)

    k = KernelDef("planted_bad_combine", (stage,), writes=("out",),
                  reads=("x", "out"), combines={"out": "max"})
    args = {"x": torch.arange(64, dtype=torch.float32),
            "out": torch.zeros(4, dtype=torch.float32)}
    return k, 2, 32, args


_INJECTIONS = {
    "race": (planted_race, "shared-race"),
    "undeclared-read": (planted_undeclared_read, "undeclared-read"),
    "bad-combine": (planted_bad_combine, "combine-mismatch"),
}


# --------------------------------------------------------------------------
# CLI: the analysis-gate entry point.
# --------------------------------------------------------------------------
def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analyze",
        description="kernelcheck: race / declaration / fusion analysis "
                    "over the CUDA suite")
    p.add_argument("--kernels", help="comma-separated suite entry names "
                                     "(default: all)")
    p.add_argument("--scale", type=int, default=1,
                   help="suite problem-size scale (default 1)")
    p.add_argument("--sample-blocks", type=int, default=3,
                   help="blocks analyzed per kernel (default 3)")
    p.add_argument("--json", metavar="PATH",
                   help="write the JSON report (fusion verdicts feed the "
                        "barrier-fission optimizer)")
    p.add_argument("--fusion-only", action="store_true",
                   help="emit only the kernelcheck-fusion-1 verdict "
                        "artifact (the schema core/optimize.py consumes); "
                        "never gates - exit 0 unless analysis itself "
                        "crashes")
    p.add_argument("--device", default=None,
                   help="cpu or cuda (default: the card)")
    for name in _INJECTIONS:
        p.add_argument(f"--inject-{name}", action="store_true",
                       help=f"self-test: plant a {name} bug and require "
                            f"kernelcheck to catch it")
    opts = p.parse_args(argv)
    device = memory.resolve_device(opts.device)

    names = [n.strip() for n in opts.kernels.split(",")] \
        if opts.kernels else None

    if opts.fusion_only:
        artifacts = fusion_suite(names=names, scale=opts.scale,
                                 sample_blocks=opts.sample_blocks,
                                 device=device)
        for a in artifacts:
            adj = [v for v in a["verdicts"]
                   if v["pair"][1] - v["pair"][0] == 1]
            ok = sum(v["mergeable"] for v in adj)
            print(f"fusion {a['kernel']}: {ok}/{len(adj)} adjacent "
                  f"pairs mergeable ({a['n_stages']} stages)")
        if opts.json:
            with open(opts.json, "w") as fh:
                json.dump(fusion_to_json(artifacts), fh, indent=2,
                          sort_keys=True)
            print(f"kernelcheck: fusion artifact written to {opts.json}")
        return 0

    reports = analyze_suite(names=names, scale=opts.scale,
                            sample_blocks=opts.sample_blocks, device=device)

    selftest_failed = []
    for name, (factory, expect_kind) in _INJECTIONS.items():
        if not getattr(opts, f"inject_{name}".replace("-", "_")):
            continue
        kernel, grid, block, args = factory()
        args = {n: v.to(device) for n, v in args.items()}
        report = analyze_kernel(kernel, grid=grid, block=block, args=args)
        reports.append(report)
        if not any(f.kind == expect_kind for f in report.findings):
            selftest_failed.append((name, expect_kind))

    for r in reports:
        if r.clean and r.fusion:
            print(f"kernelcheck {r.kernel}: clean ({len(r.fusion) + 1} "
                  f"stages, {r.n_mergeable}/{len(r.fusion)} pairs mergeable)")
        elif r.clean:
            print(f"kernelcheck {r.kernel}: clean (single stage)")
        else:
            print(f"kernelcheck {r.kernel}: {len(r.findings)} finding(s)")
            for f in r.findings:
                print(f"  {f}")

    if opts.json:
        with open(opts.json, "w") as fh:
            json.dump(report_to_json(reports), fh, indent=2, sort_keys=True)
        print(f"kernelcheck: JSON report written to {opts.json}")

    n_findings = sum(len(r.findings) for r in reports)
    n_mergeable = sum(r.n_mergeable for r in reports)
    n_pairs = sum(len(r.fusion) for r in reports)
    if selftest_failed:
        for name, kind in selftest_failed:
            print(f"kernelcheck: SELF-TEST FAILED - planted {name} bug "
                  f"produced no {kind} finding")
        return 2
    if n_findings:
        print(f"kernelcheck: FAILED ({n_findings} finding(s) across "
              f"{len(reports)} kernels)")
        return 1
    print(f"kernelcheck: OK ({len(reports)} kernels clean; "
          f"{n_mergeable}/{n_pairs} stage pairs provably mergeable)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
