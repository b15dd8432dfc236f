"""Kernel-launch API: ``kernel[<<<grid, block, dyn_shared>>>](buffers)``.

Two equivalent entry points:

* triple-chevron (CUDA-shaped): ``kernel[grid, block](**buffers)`` where
  ``grid``/``block`` are ints or up-to-3-tuples (``dim3``), with an
  optional ``dyn_shared`` slot;
* keyword: ``launch(kernel, grid=..., block=..., args=...)``.

Each launch resolves its options (:class:`LaunchConfig`), looks its
backend up in the registry (:mod:`repro_torch.core.backends`) and runs
through a :class:`~repro_torch.core.kernel.CompiledKernel` from a bounded
in-memory LRU keyed on (backend, geometry, grain, buffer shapes, dtypes
and devices).  A launch runs on the device its buffers lie on.

A stream (:class:`~repro_torch.core.streams.Stream`) in the chevrons'
fourth slot, ``kernel[grid, block, None, s](...)``, routes the launch
through ``s.launch`` (asynchronous, hazard-tracked, in place on the
stream's heap) and returns the stream.

:func:`supported` and :func:`coverage` probe a kernel through
:func:`launch`: a cell and a row of the paper's Table II.

``sanitize=True`` (or ``CUPBOP_SANITIZE=1``) runs kernelcheck
(:mod:`repro_torch.core.analyze`) on the launch first and raises
``SanitizerError`` on findings; ``optimize=True`` (or
``CUPBOP_OPTIMIZE=1``) swaps in the barrier-fission optimizer's derived
kernel (:mod:`repro_torch.core.optimize`).  An explicit ``False`` wins
over the environment.

Under the in-memory LRU sits an optional on-disk tier
(:mod:`repro_torch.core.compile_cache`, the ``cudaModuleLoad`` analogue,
enabled by ``CUPBOP_CACHE_DIR`` or :func:`enable_disk_cache`): a miss
looks for the specialization's record there before it builds, and a
launch of hand-written kernels on the card stores one, so a new process
loads the compiled library instead of running ``nvcc``.

:func:`launch_batch` runs N compatible launches as one dispatch (the
serving tier's batcher, :mod:`repro_torch.serve`), in the same LRU.

``devices=``/``shard_axis=`` reach the ``multi_device`` backends
(``shard``, ``shard_vector``: :mod:`repro_torch.core.lower_shard`) only;
:func:`device_opts` normalizes them away for every other backend, so
``launch(backend="loop", devices=4)`` shares the plain launch's cache
entry.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import weakref
from typing import Any

from repro_torch.core import _native, compile_cache
from repro_torch.core import grain as grain_mod
from repro_torch.core import memory as memory_mod
from repro_torch.core import packing
from repro_torch.core.backends import (backend_names, get_backend,
                                        register_backend)
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import (
    CompiledKernel,
    KernelDef,
    UnsupportedKernel,
)
from repro_torch.core.lower_shard import DEFAULT_AXIS

__all__ = [
    "BACKENDS", "CacheStats", "LaunchConfig", "cache_clear", "cache_resize",
    "cache_size", "cache_stats", "compiled", "coverage", "device_opts",
    "disable_disk_cache", "enable_disk_cache", "launch", "launch_batch",
    "register_backend", "supported",
]

# The cache lives ON each kernel (a private dict attached to the
# KernelDef), so entries die with their kernel; the WeakSet enumerates
# kernels for cache_clear() and the LRU ring holds (weakref, key) pairs.
_CACHE_ATTR = "_launch_cache"
_CACHED_KERNELS: "weakref.WeakSet[KernelDef]" = weakref.WeakSet()
_LRU: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
_MAX_ENTRIES = max(1, int(os.environ.get("CUPBOP_CACHE_SIZE", "256")))
_DISK: "compile_cache.DiskCache | None" = compile_cache.from_env()


@dataclasses.dataclass
class CacheStats:
    """Counters of the launch cache (reset by ``cache_clear``).

    ``hits``/``misses`` count in-memory lookups; ``disk_hits`` are misses
    served by an on-disk record instead of a build; ``disk_stores``
    count records persisted; ``evictions`` count LRU drops after the
    cache exceeded its bound.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    disk_hits: int = 0
    disk_stores: int = 0


_STATS = CacheStats()


def __getattr__(name: str):
    if name == "BACKENDS":  # a live view of the registry
        return backend_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _kernel_cache(kernel: KernelDef) -> dict:
    cache = getattr(kernel, _CACHE_ATTR, None)
    if cache is None:
        cache = {}
        object.__setattr__(kernel, _CACHE_ATTR, cache)  # frozen dataclass
        _CACHED_KERNELS.add(kernel)
    return cache


def _evict_to_bound() -> None:
    while len(_LRU) > _MAX_ENTRIES:
        (ref, old_key), _ = _LRU.popitem(last=False)
        owner = ref()
        if owner is None:          # kernel already died; stale order entry
            continue
        if getattr(owner, _CACHE_ATTR, {}).pop(old_key, None) is not None:
            _STATS.evictions += 1


def cache_clear() -> None:
    """Drop all cached launches and reset stats."""
    for k in list(_CACHED_KERNELS):
        getattr(k, _CACHE_ATTR, {}).clear()
    _LRU.clear()
    global _STATS
    _STATS = CacheStats()


def cache_size() -> int:
    return sum(len(getattr(k, _CACHE_ATTR, {})) for k in _CACHED_KERNELS)


def cache_stats() -> CacheStats:
    """A snapshot of the cache counters."""
    return dataclasses.replace(_STATS)


def cache_resize(max_entries: int) -> None:
    """Re-bound the LRU (evicting down if needed)."""
    global _MAX_ENTRIES
    if max_entries < 1:
        raise ValueError(f"cache bound must be >= 1, got {max_entries}")
    _MAX_ENTRIES = max_entries
    _evict_to_bound()


def enable_disk_cache(path: str) -> "compile_cache.DiskCache":
    """Persist compiled launches under ``path`` (cudaModuleLoad analogue)."""
    global _DISK
    _DISK = compile_cache.DiskCache(path)
    return _DISK


def disable_disk_cache() -> None:
    global _DISK
    _DISK = None


def _resolve_grain(kernel: KernelDef, grain, pool, n_blocks: int) -> int:
    if isinstance(grain, str):
        pool = pool or os.cpu_count() or 1
        if grain == "average":
            grain = grain_mod.average_grain(n_blocks, pool)
        elif grain == "aggressive":
            grain = grain_mod.heuristic_grain(n_blocks, pool,
                                              kernel.est_block_work)
        else:
            raise ValueError(f"unknown grain policy {grain!r}")
    return max(1, min(int(grain), n_blocks))


def device_opts(backend_entry, devices, shard_axis) -> dict:
    """Extra keywords for a ``multi_device`` backend's ``run``.

    Only backends tagged ``multi_device`` receive ``devices``/
    ``shard_axis``; every other backend's ``run`` keeps the plain
    signature.
    """
    if backend_entry.supports("multi_device"):
        return {"devices": devices, "shard_axis": shard_axis}
    return {}


def _build(kernel: KernelDef, backend: str, grid: Dim3, block: Dim3,
           grain: int, dyn_shared, interpret: bool, names: tuple,
           devices=None, shard_axis: str = DEFAULT_AXIS):
    entry = get_backend(backend)
    extra = device_opts(entry, devices, shard_axis)

    def fn(*leaves):
        glob = packing.unpack(leaves, names)  # kernel prologue (SIII-C.2)
        return entry.run(kernel, grid=grid, block=block, glob=glob,
                         grain=grain, dyn_shared=dyn_shared,
                         interpret=interpret, **extra)
    return fn


def _entry_for(kernel: KernelDef, grid: Dim3, block: Dim3, args: dict,
               backend: str, grain, dyn_shared, interpret: bool,
               pool, devices=None, shard_axis: str = DEFAULT_AXIS
               ) -> tuple[CompiledKernel, tuple]:
    """Resolve the launch specialization: cache hit or build."""
    grain = _resolve_grain(kernel, grain, pool, grid.size)
    # single-device backends ignore the device options: normalized out of
    # the key, launch(backend="loop", devices=4) shares the plain entry
    opts = device_opts(get_backend(backend), devices, shard_axis)
    devices = opts.get("devices")
    shard_axis = opts.get("shard_axis", DEFAULT_AXIS)
    donated = memory_mod.donated_names(kernel, args)
    args = memory_mod.resolve_launch_args(kernel, args)
    leaves, names = packing.pack(args)     # host prologue (SIII-C.2)
    shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)
    key = (backend, grid, block, grain, dyn_shared, interpret, names, shapes,
           devices, shard_axis)
    per_kernel = _kernel_cache(kernel)
    entry = per_kernel.get(key)
    if entry is not None:
        _STATS.hits += 1
        _LRU.move_to_end((weakref.ref(kernel), key))
        return entry, leaves
    _STATS.misses += 1
    entry = _compile(kernel, backend, grid, block, grain, dyn_shared,
                     interpret, names, shapes, key, donated, devices,
                     shard_axis)
    per_kernel[key] = entry
    _LRU[(weakref.ref(kernel), key)] = None
    _evict_to_bound()
    return entry, leaves


def _compiled_library(backend_entry, shapes):
    """The compiled module a launch runs: the hand-written kernels'
    library for a native backend over buffers on the card; None for an
    eager lowering or CPU buffers (nothing compiled to keep)."""
    on_card = any(dev.type == "cuda" for *_, dev in shapes)
    if backend_entry.supports("native") and on_card:
        return _native.library().path
    return None


def _compile(kernel: KernelDef, backend: str, grid: Dim3, block: Dim3,
             grain: int, dyn_shared, interpret: bool, names: tuple,
             shapes: tuple, key: tuple, donated, devices=None,
             shard_axis: str = DEFAULT_AXIS) -> CompiledKernel:
    """Cache-miss path: the disk record if there is one, else build (and
    store a record when the launch runs something compiled)."""
    backend_entry = get_backend(backend)
    # surface UnsupportedKernel before anything runs (coverage probes)
    backend_entry.check(kernel, block)
    fn = _build(kernel, backend, grid, block, grain, dyn_shared, interpret,
                names, devices, shard_axis)
    if _DISK is None:
        return CompiledKernel(kernel=kernel, backend=backend, grid=grid,
                              block=block, key=key, fn=fn)
    akey = compile_cache.artifact_key(
        kernel.fingerprint(), backend, grid, block, grain, dyn_shared,
        interpret, names, shapes, devices=devices, shard_axis=shard_axis,
        donate_idx=tuple(i for i, n in enumerate(names) if n in donated))
    if _DISK.load(akey) is not None:
        _STATS.disk_hits += 1
        return CompiledKernel(kernel=kernel, backend=backend, grid=grid,
                              block=block, key=key, fn=fn, source="disk")
    if _DISK.store(akey, _compiled_library(backend_entry, shapes),
                   fingerprint=kernel.fingerprint(), backend=backend):
        _STATS.disk_stores += 1
    return CompiledKernel(kernel=kernel, backend=backend, grid=grid,
                          block=block, key=key, fn=fn, source="trace")


# analyze (and optimize, which imports it) is imported where it is used:
# it runs as a ``python -m`` gate, which this package's import must not
# pre-load


def _sanitize_enabled(sanitize) -> bool:
    """Explicit ``sanitize=`` wins; otherwise ``CUPBOP_SANITIZE``."""
    if sanitize is not None:
        return bool(sanitize)
    return os.environ.get("CUPBOP_SANITIZE", "0") not in ("", "0")


def _optimize_enabled(optimize) -> bool:
    """Explicit ``optimize=`` wins; otherwise ``CUPBOP_OPTIMIZE``."""
    if optimize is not None:
        return bool(optimize)
    return os.environ.get("CUPBOP_OPTIMIZE", "0") not in ("", "0")


def _optimized(kernel: KernelDef, grid: Dim3, block: Dim3, args: dict,
               dyn_shared, optimize) -> KernelDef:
    """The kernel a launch runs: the optimizer's derived kernel (memoized
    per geometry and shapes) when ``optimize`` resolves true."""
    if not _optimize_enabled(optimize):
        return kernel
    from repro_torch.core import optimize as optimize_mod
    return optimize_mod.optimize_launch(kernel, grid=grid, block=block,
                                        args=args, dyn_shared=dyn_shared)


def _launch(kernel: KernelDef, grid: Dim3, block: Dim3, args: dict,
            backend: str, grain, dyn_shared, interpret: bool,
            pool, devices=None, shard_axis: str = DEFAULT_AXIS,
            sanitize=None, optimize=None) -> dict:
    if _sanitize_enabled(sanitize):
        # kernelcheck gate on the BASE kernel (finding stage indices match
        # the author's source); clean verdicts are memoized on the kernel
        from repro_torch.core import analyze as analyze_mod
        analyze_mod.sanitize_launch(kernel, grid=grid, block=block,
                                    args=args, dyn_shared=dyn_shared)
    kernel = _optimized(kernel, grid, block, args, dyn_shared, optimize)
    entry, leaves = _entry_for(kernel, grid, block, args, backend, grain,
                               dyn_shared, interpret, pool, devices,
                               shard_axis)
    out = entry(*leaves)
    # donated handle-bound buffers come back as the SAME handle, re-bound
    # to the kernel's output (the CUDA in-place view)
    return memory_mod.rebind_outputs(kernel, args, out)


def compiled(kernel: KernelDef, *, grid, block, args: dict,
             backend: str = "vector", grain: int | str = 1,
             dyn_shared: int | None = None, interpret: bool = True,
             pool: int | None = None, devices: int | None = None,
             shard_axis: str = DEFAULT_AXIS,
             optimize=None) -> CompiledKernel:
    """Resolve (or fetch) the launch specialization without running it:
    the ``cudaModuleGetFunction`` analogue.  ``optimize=True`` resolves
    the barrier-fission optimizer's derived kernel's specialization
    instead (its own cache, never the base kernel's)."""
    grid, block = Dim3.of(grid), Dim3.of(block)
    kernel = _optimized(kernel, grid, block, args, dyn_shared, optimize)
    entry, _ = _entry_for(kernel, grid, block, args, backend, grain,
                          dyn_shared, interpret, pool, devices, shard_axis)
    return entry


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """A kernel bound to its ``<<<grid, block, dyn_shared>>>``.

    Calling it launches: buffers go in as keyword arguments (or one
    positional dict) and the updated buffer dict comes back.  Options
    CUDA keeps out of the chevrons are set with :meth:`on`::

        out = kernel[(gx, gy), (bx, by)].on(backend="cuda")(t=t, p=p)
        out = kernel[grid, block].on(backend="shard", devices=4)(x=x)

    When a ``stream`` occupies the fourth chevron slot the launch is routed
    through ``stream.launch`` (async, hazard-tracked) and returns the
    stream; otherwise it is a synchronous launch returning the updated
    buffers.
    """

    kernel: KernelDef
    grid: Dim3
    block: Dim3
    dyn_shared: int | None = None
    stream: Any = None
    backend: str = "vector"
    grain: int | str = 1
    interpret: bool = True
    pool: int | None = None
    devices: int | None = None
    shard_axis: str = DEFAULT_AXIS
    sanitize: bool | None = None
    optimize: bool | None = None

    @classmethod
    def from_chevron(cls, kernel: KernelDef, config: tuple) -> "LaunchConfig":
        grid, block, *rest = config
        dyn_shared = rest[0] if len(rest) >= 1 else None
        stream = rest[1] if len(rest) >= 2 else None
        if dyn_shared is not None and not isinstance(dyn_shared, int):
            raise TypeError(
                f"kernel {kernel.name}: third chevron slot (dyn_shared) must "
                f"be an int or None, got {dyn_shared!r}")
        return cls(kernel=kernel, grid=Dim3.of(grid), block=Dim3.of(block),
                   dyn_shared=dyn_shared, stream=stream)

    def on(self, **overrides) -> "LaunchConfig":
        """Re-bind execution options: backend, grain, interpret, pool,
        devices (shard count for multi-device backends; None = the whole
        pool), shard_axis (its label), sanitize, optimize."""
        allowed = {"backend", "grain", "interpret", "pool", "devices",
                   "shard_axis", "sanitize", "optimize"}
        bad = set(overrides) - allowed
        if bad:
            raise TypeError(f"LaunchConfig.on() got unexpected options "
                            f"{sorted(bad)}; allowed: {sorted(allowed)}")
        return dataclasses.replace(self, **overrides)

    def __call__(self, args: dict | None = None, /, **buffers):
        merged = {**(args or {}), **buffers}
        if self.stream is not None:
            self.stream.launch(
                self.kernel, grid=self.grid, block=self.block,
                backend=self.backend, grain=self.grain,
                dyn_shared=self.dyn_shared, args=merged or None,
                interpret=self.interpret, pool=self.pool,
                devices=self.devices, shard_axis=self.shard_axis,
                optimize=self.optimize)
            return self.stream
        return _launch(self.kernel, self.grid, self.block, merged,
                       self.backend, self.grain, self.dyn_shared,
                       self.interpret, self.pool, self.devices,
                       self.shard_axis, self.sanitize, self.optimize)


def launch(kernel: KernelDef, *, grid, block, args: dict,
           backend: str = "vector", grain: int | str = 1,
           dyn_shared: int | None = None, interpret: bool = True,
           pool: int | None = None, devices: int | None = None,
           shard_axis: str = DEFAULT_AXIS,
           sanitize=None, optimize=None) -> dict:
    """Launch ``kernel`` over ``grid`` blocks of ``block`` threads.

    ``args`` maps global-buffer names to tensors (or ``DeviceBuffer``/
    ``ConstArray`` handles); returns the dict with the kernel's written
    buffers replaced.  ``grain`` may be an int, "average" or "aggressive"
    (paper SIV-A; ``pool`` = worker count).  ``devices``/``shard_axis``
    reach multi-device backends (``shard``, ``shard_vector``) only;
    single-device backends ignore them.  ``sanitize=True`` (or
    ``CUPBOP_SANITIZE=1``) runs kernelcheck on the launch first and raises
    ``SanitizerError`` on findings; ``optimize=True`` (or
    ``CUPBOP_OPTIMIZE=1``) runs the barrier-fission optimizer's derived
    kernel - the same bits from fewer stages (on ``cuda``, the same
    hand-written kernel).
    """
    return _launch(kernel, Dim3.of(grid), Dim3.of(block), args, backend,
                   grain, dyn_shared, interpret, pool, devices, shard_axis,
                   sanitize, optimize)


def _build_batch(kernel: KernelDef, backend: str, grid: Dim3, block: Dim3,
                 grain: int, dyn_shared, interpret: bool, names: tuple):
    """The entry running a batch of one specialization: rows of leaves
    in, one result dict per row out.

    The rows run through the per-launch function in turn.  The eager
    lowerings have no trace to amortise; on ``cuda`` over buffers on the
    card that is one launch of the hand-written kernel a row, back to back
    on the current stream.  A CUDA graph of the rows' launches over
    stacked buffers saves the host's time a launch but copies every row in
    and out: on the card it lost in sum (``tools/serve_batch_forms.py``,
    PERF.md).  Each row is the launch it replaces, bit for bit.
    """
    one = _build(kernel, backend, grid, block, grain, dyn_shared, interpret,
                 names)
    return lambda rows: [one(*leaves) for leaves in rows]


def launch_batch(kernel: KernelDef, *, grid, block, args_list: list[dict],
                 backend: str = "vector", grain: int | str = 1,
                 dyn_shared: int | None = None, interpret: bool = True,
                 pool: int | None = None, sanitize=None,
                 optimize=None) -> list[dict]:
    """Run N compatible launches of ``kernel`` as one dispatch.

    The serving tier's batcher: every dict in ``args_list`` must bind the
    same buffers with the same shapes, dtypes and device - request ``i``
    is row ``i`` of the batch, one entry runs all rows, and one result
    dict comes back per request, each bit for bit the independent
    :func:`launch` it replaces.  Batched entries live in the same LRU and
    :class:`CacheStats` as plain launches (keyed with a ``("batch", n)``
    component), so a warm batch is a cache hit like any other.

    Handle liveness and const-space enforcement run on every request, and
    donated handles re-bind to their row's output.  ``sanitize`` and
    ``optimize`` run on ``args_list[0]``; a batch of one is a plain
    launch.  A multi-device backend raises :class:`UnsupportedKernel`:
    stacked batching is single-device.
    """
    if not args_list:
        raise ValueError("launch_batch: args_list must be non-empty")
    grid, block = Dim3.of(grid), Dim3.of(block)
    if _sanitize_enabled(sanitize):
        from repro_torch.core import analyze as analyze_mod
        analyze_mod.sanitize_launch(kernel, grid=grid, block=block,
                                    args=args_list[0], dyn_shared=dyn_shared)
    kernel = _optimized(kernel, grid, block, args_list[0], dyn_shared,
                        optimize)
    if len(args_list) == 1:
        # the passes ran above: suppress the environment's defaults here
        return [_launch(kernel, grid, block, args_list[0], backend, grain,
                        dyn_shared, interpret, pool, sanitize=False,
                        optimize=False)]
    if get_backend(backend).supports("multi_device"):
        raise UnsupportedKernel(
            f"launch_batch: backend {backend!r} shards blocks across "
            f"devices; stacked request batching is single-device only - "
            f"dispatch these requests independently")
    grain = _resolve_grain(kernel, grain, pool, grid.size)
    rows, names0, shapes0 = [], None, None
    for i, a in enumerate(args_list):
        leaves, names = packing.pack(
            memory_mod.resolve_launch_args(kernel, a))
        shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)
        if i == 0:
            names0, shapes0 = names, shapes
        elif (names, shapes) != (names0, shapes0):
            raise ValueError(
                f"launch_batch: request {i} does not match the batch "
                f"specialization (buffer names or shapes/dtypes/devices "
                f"differ from request 0); only compatible launches stack")
        rows.append(leaves)
    n = len(rows)
    key = ("batch", n, backend, grid, block, grain, dyn_shared, interpret,
           names0, shapes0)
    per_kernel = _kernel_cache(kernel)
    entry = per_kernel.get(key)
    if entry is not None:
        _STATS.hits += 1
        _LRU.move_to_end((weakref.ref(kernel), key))
    else:
        _STATS.misses += 1
        # surface UnsupportedKernel before anything runs
        get_backend(backend).check(kernel, block)
        entry = CompiledKernel(
            kernel=kernel, backend=backend, grid=grid, block=block, key=key,
            fn=_build_batch(kernel, backend, grid, block, grain, dyn_shared,
                            interpret, names0))
        per_kernel[key] = entry
        _LRU[(weakref.ref(kernel), key)] = None
        _evict_to_bound()
    outs = entry(rows)
    return [memory_mod.rebind_outputs(kernel, a, out)
            for a, out in zip(args_list, outs)]


def supported(kernel: KernelDef, backend: str, *, grid=4, block=64,
              args=None, dyn_shared=None) -> bool:
    """Coverage probe: can ``backend`` express ``kernel``? (a Table-II cell)

    The probe is one :func:`launch` over ``args``; only
    :class:`UnsupportedKernel` reads as "unsupported", anything else
    raises.  ``backend`` must name a registered backend: an unknown name
    raises ``UnknownBackend``.
    """
    get_backend(backend)
    if args is None:
        raise ValueError("supported() needs representative args")
    try:
        launch(kernel, grid=grid, block=block, args=args, backend=backend,
               dyn_shared=dyn_shared)
    except UnsupportedKernel:
        return False
    return True


def coverage(kernel: KernelDef, *, grid=4, block=64, args=None,
             dyn_shared=None) -> dict[str, bool]:
    """One Table-II row: :func:`supported` across every registered
    backend, in registration order."""
    return {name: supported(kernel, name, grid=grid, block=block, args=args,
                            dyn_shared=dyn_shared)
            for name in backend_names()}
