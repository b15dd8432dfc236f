"""Kernel IR of the PyTorch port.

A CUDA-style SPMD kernel is a :class:`KernelDef`: an ordered tuple of
**stages** separated by implicit ``__syncthreads()`` barriers, a
declaration of ``__shared__`` memory, and the global buffers the kernel
writes.  Stage functions are written against a :class:`Ctx` and a
:class:`BlockState` and run unchanged under the port's ``loop`` and
``vector`` lowerings:

* every thread-private value carries a leading *thread-chunk* axis (1, or
  32 for warp-level kernels, under ``loop``; the whole block under
  ``vector``);
* shared and global arrays are read with :func:`repro_torch.core.index.take`
  and updated with :func:`repro_torch.core.index.put`, which follow JAX's
  out-of-range rules so the port's stages compute what the reference's do.

A kernel may also carry a :class:`Native` descriptor: the symbol of a
hand-written CUDA kernel plus its scalar parameters.  The ``cuda`` backend
(:mod:`repro_torch.core.lower_cuda`) launches that kernel instead of the
stages; a kernel without one is unsupported there.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import torch

from repro_torch.core.dim3 import Dim3

WARP_SIZE = 32


class UnsupportedKernel(Exception):
    """Raised when a lowering cannot express a kernel feature.

    This is the analogue of an 'unsupport' cell in the paper's Table II."""


class BlockState(NamedTuple):
    """Functional view of one CUDA block's memory during a stage.

    priv   : dict of thread-private tensors; every leaf has leading axis
             = thread-chunk size (demoted to ``[block_size, ...]`` across
             barriers by the loop lowering).
    shared : dict name -> tensor, the block's ``__shared__`` memory.
    glob   : dict name -> tensor, global-memory buffers.
    """

    priv: Any
    shared: dict
    glob: dict

    def with_priv(self, priv: Any) -> "BlockState":
        return self._replace(priv=priv)

    def set_shared(self, **kv: Any) -> "BlockState":
        return self._replace(shared={**self.shared, **kv})

    def set_glob(self, **kv: Any) -> "BlockState":
        return self._replace(glob={**self.glob, **kv})


@dataclasses.dataclass
class Ctx:
    """Per-stage execution context: CUDA special registers + intrinsics.

    ``bid`` is the linear block id (a python int: the lowerings loop over
    blocks in Python) and ``tid`` the ``[chunk]`` int32 tensor of linear
    thread ids; ``bid3``/``tid3`` recover ``blockIdx``/``threadIdx``
    triples with CUDA's x-fastest ordering.
    """

    bid: Any
    tid: torch.Tensor
    block_dim: int
    grid_dim: int
    backend: str
    uses_warp: bool = False
    block_dim3: Dim3 | None = None
    grid_dim3: Dim3 | None = None

    def __post_init__(self):
        if self.block_dim3 is None:
            self.block_dim3 = Dim3(int(self.block_dim))
        if self.grid_dim3 is None and isinstance(self.grid_dim, int):
            self.grid_dim3 = Dim3(int(self.grid_dim))

    @property
    def tid3(self):
        """``threadIdx`` as an ``(x, y, z)`` triple of [chunk] tensors."""
        return self.block_dim3.coords(self.tid)

    @property
    def bid3(self):
        """``blockIdx`` as an ``(x, y, z)`` triple."""
        if self.grid_dim3 is None:
            raise UnsupportedKernel(
                "blockIdx read with no Dim3 grid geometry: blockIdx.y/z "
                "would silently flatten to 0. Pass grid_dim3= when "
                "constructing Ctx (the lowerings do).")
        return self.grid_dim3.coords(self.bid)

    @property
    def lane(self):
        return self.tid % WARP_SIZE

    @property
    def warp(self):
        return self.tid // WARP_SIZE

    # ---- warp-level functions ------------------------------------------
    def shfl(self, val, src_lane):
        from repro_torch.core import warp
        return warp.shfl(val, src_lane)

    def shfl_up(self, val, delta):
        from repro_torch.core import warp
        return warp.shfl_up(val, delta)

    def shfl_down(self, val, delta):
        from repro_torch.core import warp
        return warp.shfl_down(val, delta)

    def shfl_xor(self, val, mask):
        from repro_torch.core import warp
        return warp.shfl_xor(val, mask)

    def vote_all(self, pred):
        from repro_torch.core import warp
        return warp.vote_all(pred)

    def vote_any(self, pred):
        from repro_torch.core import warp
        return warp.vote_any(pred)

    def ballot(self, pred):
        from repro_torch.core import warp
        return warp.ballot(pred)

    def warp_reduce(self, val, op="add"):
        from repro_torch.core import warp
        return warp.reduce(val, op)

    def syncthreads_count(self, pred):
        """``__syncthreads_count``: block-wide count of true predicates.

        The thread chunk must span the whole block (always under
        ``vector``; under ``loop`` only for 32-thread warp-mode blocks)."""
        from repro_torch.core import warp
        return warp.syncthreads_count(pred, self.block_dim)

    # ---- atomics (deterministic: the block loop runs in order) ----------
    def atomic_add(self, arr, idx, val):
        from repro_torch.core import atomics
        return atomics.atomic_add(arr, idx, val)

    def atomic_max(self, arr, idx, val):
        from repro_torch.core import atomics
        return atomics.atomic_max(arr, idx, val)

    def atomic_min(self, arr, idx, val):
        from repro_torch.core import atomics
        return atomics.atomic_min(arr, idx, val)

    def atomic_cas(self, arr, idx, cmp, val):
        from repro_torch.core import atomics
        return atomics.atomic_cas(arr, idx, cmp, val)

    def atomic_exch(self, arr, idx, val):
        from repro_torch.core import atomics
        return atomics.atomic_exch(arr, idx, val)

    def atomic_cas_first(self, arr, idx, cmp, val):
        from repro_torch.core import atomics
        return atomics.atomic_cas_first(arr, idx, cmp, val)


Stage = Callable[[Ctx, BlockState], BlockState]


@dataclasses.dataclass(frozen=True)
class Native:
    """A hand-written CUDA kernel that computes one launch of a KernelDef.

    ``symbol`` names the wrapper in :mod:`repro_torch.core.lower_cuda`;
    ``params`` are its scalar parameters as sorted ``(name, value)`` pairs
    (runtime arguments of the kernel, so one build serves every size).
    """

    symbol: str
    params: tuple[tuple[str, Any], ...] = ()

    @classmethod
    def of(cls, symbol: str, **params) -> "Native":
        return cls(symbol, tuple(sorted(params.items())))


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: hash by identity
class KernelDef:
    """A CUDA kernel after barrier fission.

    ``stages`` are the code regions between ``__syncthreads()``;
    ``shared`` declares ``__shared__`` arrays as ``name -> (shape, dtype)``
    (a ``-1`` extent is extern dynamic shared memory, sized by the
    ``dyn_shared`` launch slot); ``writes`` names the global buffers the
    kernel mutates and ``reads`` those it consumes.  ``combines`` and
    ``donates`` keep the reference's declarations (validated here, hashed
    into the fingerprint).  ``native`` is the ``cuda`` backend's kernel.

    Subscripting a kernel is the triple-chevron launch syntax::

        kernel[grid, block](**buffers)                     # <<<g, b>>>
        kernel[(gx, gy), (bx, by)](**buffers)              # dim3 grids
        kernel[grid, block, shmem](**buffers)              # <<<g, b, s>>>
    """

    name: str
    stages: Sequence[Stage]
    writes: Sequence[str]
    shared: Mapping[str, tuple[tuple[int, ...], torch.dtype]] = \
        dataclasses.field(default_factory=dict)
    reads: Sequence[str] | None = None
    uses_warp: bool = False
    est_block_work: float = 1e6
    combines: Mapping[str, str] = dataclasses.field(default_factory=dict)
    donates: Sequence[str] = ()
    native: Native | None = None

    def __post_init__(self):
        from repro_torch.core import atomics  # lazy: atomics imports us
        stray = set(self.donates) - set(self.writes)
        if stray:
            raise ValueError(
                f"kernel {self.name}: donates {sorted(stray)} not in writes "
                f"{tuple(self.writes)}; only written buffers can consume "
                f"their input storage")
        unwritten = set(self.combines) - set(self.writes)
        if unwritten:
            raise ValueError(
                f"kernel {self.name}: combines for {sorted(unwritten)} not "
                f"in writes {tuple(self.writes)}")
        bad = {n: m for n, m in self.combines.items()
               if m not in atomics.CROSS_SHARD_COMBINES}
        if bad:
            raise ValueError(
                f"kernel {self.name}: unknown combine mode(s) {bad}; "
                f"supported: {atomics.CROSS_SHARD_COMBINES}")

    def __getitem__(self, config):
        """``kernel[grid, block(, dyn_shared(, stream))]`` -> LaunchConfig."""
        from repro_torch.core.api import LaunchConfig  # lazy: api imports us

        if not isinstance(config, tuple) or not 2 <= len(config) <= 4:
            raise TypeError(
                f"kernel {self.name}: launch config must be "
                f"[grid, block(, dyn_shared(, stream))]; got {config!r}")
        return LaunchConfig.from_chevron(self, config)

    def resolved_shared(self, dyn_shared: int | None):
        out = {}
        for name, (shape, dtype) in self.shared.items():
            if any(d == -1 for d in shape):
                if dyn_shared is None:
                    raise ValueError(
                        f"kernel {self.name}: shared array {name} is extern "
                        f"(dynamic); pass dyn_shared= at launch")
                shape = tuple(dyn_shared if d == -1 else d for d in shape)
            out[name] = (tuple(int(d) for d in shape), dtype)
        return out

    def init_shared(self, dyn_shared: int | None, device) -> dict:
        return {name: torch.zeros(shape, dtype=dtype, device=device)
                for name, (shape, dtype)
                in self.resolved_shared(dyn_shared).items()}

    def fingerprint(self) -> str:
        """Content hash of the kernel, stable across processes.

        Covers the name, declarations, the native descriptor and the
        stage bodies (bytecode plus captured cell values)."""
        h = hashlib.sha256()
        h.update(repr((self.name, tuple(self.writes),
                       None if self.reads is None else tuple(self.reads),
                       tuple(sorted((n, (tuple(s), str(d)))
                                    for n, (s, d) in self.shared.items())),
                       self.uses_warp,
                       tuple(sorted(self.combines.items())),
                       tuple(self.donates), self.native)).encode())
        for stage in self.stages:
            _hash_callable(h, stage, depth=0)
        return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class ChainStep:
    """One launch of a :class:`LaunchChain`.

    ``prepare`` runs host-side *before* the launch and returns a dict of
    buffer overrides merged into the heap (bump the iteration scalar,
    ping-pong src/dst, re-zero an accumulator).  It receives
    ``(iteration, buffers)`` and must not mutate ``buffers``.
    """

    kernel: KernelDef
    grid: Any
    block: Any
    dyn_shared: int | None = None
    prepare: Callable[[int, dict], dict] | None = None


@dataclasses.dataclass
class ChainStats:
    """Replay counters for one :class:`LaunchChain` run.

    ``host_syncs`` counts stop-flag reads back to the host."""

    iterations: int = 0
    launches: int = 0
    host_syncs: int = 0

    @property
    def syncs_per_iteration(self) -> float:
        return self.host_syncs / max(1, self.iterations)


@dataclasses.dataclass(frozen=True)
class LaunchChain:
    """Inter-launch dependency idiom for iterative wavefront kernels.

    ``steps`` run in order, the whole sequence ``repeat`` times, with
    ``stop(buffers)`` checked host-side between iterations (Rodinia BFS
    reading back its stop flag).  The caller supplies ``launch_step``,
    which runs one :class:`ChainStep` under whatever backend it chose.
    """

    steps: Sequence[ChainStep]
    repeat: int = 1
    stop: Callable[[dict], bool] | None = None

    def run(self, launch_step: Callable[[ChainStep, dict], dict],
            bufs: dict, stats: ChainStats | None = None) -> dict:
        """Host-hop replay: host prepare hooks, stop checked per iteration."""
        for it in range(self.repeat):
            if it and self.stop is not None:
                if stats is not None:
                    stats.host_syncs += 1
                if self.stop(bufs):
                    break
            for step in self.steps:
                if step.prepare is not None:
                    bufs = {**bufs, **step.prepare(it, bufs)}
                bufs = {**bufs, **launch_step(step, bufs)}
                if stats is not None:
                    stats.launches += 1
            if stats is not None:
                stats.iterations += 1
        return bufs


def _hash_callable(h, fn: Callable, depth: int) -> None:
    code = getattr(fn, "__code__", None)
    if code is None or depth > 4:    # builtins / pathological nesting
        h.update(repr(fn).encode())
        return
    h.update(code.co_code)
    h.update(repr([c for c in code.co_consts
                   if not hasattr(c, "co_code")]).encode())
    for const in code.co_consts:     # nested lambdas/defs inside the stage
        if hasattr(const, "co_code"):
            h.update(const.co_code)
    for cell in fn.__closure__ or ():
        try:
            v = cell.cell_contents
        except ValueError:           # empty cell
            continue
        if callable(v):
            _hash_callable(h, v, depth + 1)
        elif isinstance(v, torch.Tensor):
            arr = v.detach().cpu()
            h.update(repr((tuple(arr.shape), str(arr.dtype))).encode())
            h.update(arr.contiguous().numpy().tobytes())
        else:
            h.update(repr(v).encode())


@dataclasses.dataclass
class CompiledKernel:
    """A launch specialization: CuPBoP's ``CUmodule``.

    One entry per (kernel, backend, geometry, argument-shape) key in the
    launch cache; ``fn`` runs over packed leaves (the ``void**`` ABI of
    :mod:`repro_torch.core.packing`) and ``hits`` counts its launches.
    """

    kernel: KernelDef
    backend: str
    grid: Dim3
    block: Dim3
    key: tuple
    fn: Callable
    source: str = "trace"
    hits: int = 0

    def __call__(self, *leaves):
        self.hits += 1
        return self.fn(*leaves)


def block_range_limit(bid_start: int, count: int, n_blocks: int) -> int:
    """Exclusive upper block-id bound for a block-range view.

    Grain fetch loops round ``count`` up to a grain multiple; the
    lowerings mask against this limit, not only against the grid size.
    """
    return min(bid_start + count, n_blocks)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def check_priv_chunk(priv: Any, chunk: int, kernel_name: str,
                     stage_idx: int):
    """Enforce the thread-chunk leading-axis contract on priv leaves."""
    for leaf in _leaves(priv):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or shape[0] != chunk:
            raise UnsupportedKernel(
                f"kernel {kernel_name} stage {stage_idx}: thread-private leaf "
                f"has shape {shape}, expected leading thread-chunk axis "
                f"{chunk}. Broadcast scalars with torch.full((chunk,), v).")
