"""Per-device cost analysis (the dry run's profiler), as
``repro/launch/hlo_analysis.py``.

PyTorch has no HLO: the port counts what eager dispatch runs.  ``fn``
runs under a ``TorchDispatchMode`` (:class:`Tracer`), on meta tensors in
the dry run, and every aten op on **plain** tensors is counted once.
Under DTensor a compute op reaches the mode twice - once at the DTensor
level (global shapes, DTensor arguments) and once as the local op on each
device's shard - so ops with a DTensor argument are skipped: what is
counted is one device's work.  DTensor's collectives reach the mode as
``_c10d_functional`` ops on plain tensors.

* FLOPs: ``torch.utils.flop_counter``'s formulas for the matrix products
  and convolutions (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolution); 1 per output element for the reference's elementwise
  class and for reductions, 4 for its transcendental class;
* bytes: operands plus result of every op that touches memory; views and
  metadata ops are free.  Eager has no fusion, so every intermediate is
  read and written once: the reference's count is XLA's fused graph, and
  this one is an upper bound on it;
* collectives: per-device link bytes with the reference's ring formulas -
  all-reduce 2x(n-1)/n, all-gather / all-to-all (n-1)/n of the result,
  reduce-scatter (n-1)x the result (the scattered shard), a broadcast or
  permute 1x - with ``n`` the op's group size.

The reference's HLO parser (``parse_computations``, ``Op``) and
``_trip_count`` have no counterpart: eager runs the Python loop over the
layers, so every trip is counted as it runs.  The tracer also follows the
bytes of live storages (:attr:`Tracer.peak_bytes`), which the dry run
reports as the peak of one device's memory.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.float16: 2, torch.bfloat16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

_A = torch.ops.aten
#: the reference's elementwise class (1 FLOP an output element)
ELEMENTWISE = {
    _A.add, _A.sub, _A.rsub, _A.mul, _A.div, _A.maximum, _A.minimum,
    _A.abs, _A.neg, _A.eq, _A.ne, _A.lt, _A.le, _A.gt, _A.ge, _A.where,
    _A.logical_and, _A.logical_or, _A.logical_xor, _A.logical_not,
    _A.bitwise_and, _A.bitwise_or, _A.bitwise_xor, _A.bitwise_not,
    _A.clamp, _A.clamp_min, _A.clamp_max, _A.floor, _A.ceil, _A.round,
    _A.sign, _A.remainder, _A.fmod, _A.relu, _A.square, _A.lerp,
    _A.masked_fill, _A.addcmul, _A.addcdiv,
}
#: the reference's transcendental class (4 FLOPs an output element)
TRANSCENDENTAL = {
    _A.exp, _A.log, _A.rsqrt, _A.sqrt, _A.tanh, _A.pow, _A.sigmoid,
    _A.sin, _A.cos, _A.expm1, _A.log1p, _A.atan2, _A.erf, _A.reciprocal,
    _A.logaddexp, _A.silu, _A.gelu, _A.softplus,
}
#: reductions (1 FLOP an output element, as the reference counts reduce)
REDUCTIONS = {
    _A.sum, _A.mean, _A.amax, _A.amin, _A.max, _A.min, _A.prod,
    _A.logsumexp, _A.cumsum, _A.var, _A.std, _A.any, _A.all, _A.argmax,
    _A.argmin, _A._softmax, _A._log_softmax, _A.norm, _A.linalg_vector_norm,
}
#: views and metadata: no bytes moved (every other op touches memory,
#: so the reference's MEMORY_OPS has no counterpart)
SKIP_BYTES = {
    _A.view, _A._unsafe_view, _A.reshape, _A.expand, _A.permute,
    _A.transpose, _A.t, _A.as_strided, _A.slice, _A.select, _A.unsqueeze,
    _A.squeeze, _A.detach, _A.alias, _A.split, _A.split_with_sizes,
    _A.chunk, _A.unbind, _A.lift_fresh, _A.empty, _A.empty_like,
    _A.new_empty, _A.empty_strided, _A.new_empty_strided, _A.view_as,
    _A.unfold, _A.diagonal, _A.narrow, _A._reshape_alias, _A.sym_size,
    _A.sym_stride, _A.sym_numel, _A.is_same_size, _A.resize_,
}
#: ``_c10d_functional`` collectives and their ring factor's kind
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0          # per-device link bytes
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    def __add__(self, o):
        cc = defaultdict(float, self.coll_counts)
        for k, v in o.coll_counts.items():
            cc[k] += v
        return Costs(self.flops + o.flops, self.bytes + o.bytes,
                     self.coll_bytes + o.coll_bytes, cc)

    def scale(self, f):
        return Costs(self.flops * f, self.bytes * f, self.coll_bytes * f,
                     defaultdict(float, {k: v * f
                                         for k, v in self.coll_counts.items()}))


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, t.element_size())


def _group_size(func, args, kwargs, num_partitions: int) -> int:
    """The group size of a ``_c10d_functional`` op, read from its schema:
    its ``group_size`` argument where it has one, else the size of the
    group its ``group_name`` names; ``num_partitions`` only for an op
    that names no group."""
    bound = {a.name: args[i] if i < len(args) else kwargs.get(a.name)
             for i, a in enumerate(func._schema.arguments)}
    if bound.get("group_size"):
        return int(bound["group_size"])
    group = bound.get("group_name")
    if group is None:
        return num_partitions
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    return group.size()


class Tracer(TorchDispatchMode):
    """Counts one device's work (module docstring) and follows the bytes
    of live storages created under it.  ``ops`` keeps ``(bytes, op name,
    result shape)`` of each counted op for :func:`top_ops`."""

    def __init__(self, num_partitions: int = 1, keep_ops: bool = False):
        super().__init__()
        self.costs = Costs()
        self.num_partitions = num_partitions
        self.keep_ops = keep_ops
        self.ops: list = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: dict[int, int] = {}

    def known(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors (the arguments) as not
        created here."""
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            self._seen[t.untyped_storage()._cdata] = 0

    def _track(self, out) -> None:
        for t in _tensors(out):
            if type(t) is not torch.Tensor:
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._seen:
                continue
            n = s.nbytes()
            self._seen[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # a DTensor-level op: DTensor takes it, and its local ops and
            # collectives come back here on plain tensors
            return NotImplemented
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return out          # DTensor's sharding propagation on fakes
        self._track(out)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.costs
        packet = func.overloadpacket
        ns = func.namespace
        outs = _tensors(out)
        if ns == "_c10d_functional":
            name = packet.__name__
            kind = COLLECTIVES.get(name)
            if kind is None:              # wait_tensor and the like
                return
            n = _group_size(func, args, kwargs, self.num_partitions)
            sz = float(sum(_nbytes(t) for t in outs))
            if kind == "all-reduce":
                link = 2.0 * sz * (n - 1) / max(n, 1)
            elif kind in ("all-gather", "all-to-all"):
                link = sz * (n - 1) / max(n, 1)
            elif kind == "reduce-scatter":
                link = sz * (n - 1)
            else:
                link = sz
            c.coll_bytes += link
            c.coll_counts[kind] += 1
            c.bytes += sz + sum(_nbytes(t) for t in _tensors(args))
            return
        if packet in SKIP_BYTES:
            return
        elems = float(outs[0].numel()) if outs else 0.0
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in ELEMENTWISE:
            c.flops += elems
        elif packet in TRANSCENDENTAL:
            c.flops += 4 * elems
        elif packet in REDUCTIONS:
            c.flops += elems
        b = sum(_nbytes(t) for t in outs) + sum(
            _nbytes(t) for t in _tensors(args) + _tensors(kwargs))
        c.bytes += b
        if self.keep_ops:
            self.ops.append((b, packet.__name__,
                             tuple(outs[0].shape) if outs else ()))


def trace(fn, *args, num_partitions: int = 1, keep_ops: bool = False,
          **kwargs):
    """``(fn's result, Tracer)``: ``fn(*args, **kwargs)`` run under a
    :class:`Tracer`, its arguments' storages known beforehand."""
    tracer = Tracer(num_partitions, keep_ops)
    tracer.known((args, kwargs))
    with tracer:
        out = fn(*args, **kwargs)
    return out, tracer


def analyze(fn, *args, num_partitions: int = 1, **kwargs) -> Costs:
    """One device's :class:`Costs` of ``fn(*args, **kwargs)``."""
    return trace(fn, *args, num_partitions=num_partitions, **kwargs)[1].costs


def top_ops(fn, *args, n: int = 12, num_partitions: int = 1, **kwargs):
    """The ``n`` costliest ops by bytes - the dry run's 'profile': ``(total
    bytes, count, op, result shape)``, summed over the ops of one name and
    shape."""
    _, tracer = trace(fn, *args, num_partitions=num_partitions,
                      keep_ops=True, **kwargs)
    agg: dict = defaultdict(lambda: [0.0, 0])
    for b, name, shape in tracer.ops:
        agg[(name, shape)][0] += b
        agg[(name, shape)][1] += 1
    items = [(b, cnt, name, shape) for (name, shape), (b, cnt) in agg.items()]
    items.sort(reverse=True)
    return items[:n]
