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

Not yet ported, and refused rather than ignored: the reference's on-disk
compile cache (``enable_disk_cache``, ``CUPBOP_CACHE_DIR``),
``launch_batch``, ``sanitize=``/``optimize=`` (and their environment
switches), the stream slot of the chevrons, and ``devices=``/
``shard_axis=``.  Each raises ``NotImplementedError`` naming the ROADMAP
item that brings it.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import weakref

from repro_torch.core import grain as grain_mod
from repro_torch.core import memory as memory_mod
from repro_torch.core import packing
from repro_torch.core.backends import get_backend
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import CompiledKernel, KernelDef

__all__ = [
    "CacheStats", "LaunchConfig", "cache_clear", "cache_resize",
    "cache_size", "cache_stats", "compiled", "enable_disk_cache", "launch",
    "launch_batch",
]

#: options of the reference's launch path that the port does not have yet,
#: with the ROADMAP item that brings each
NOT_PORTED = {
    "sanitize": "ROADMAP 1.9 (kernelcheck)",
    "optimize": "ROADMAP 1.9 (barrier-fission optimizer)",
    "devices": "ROADMAP 1.12 (shard)",
    "shard_axis": "ROADMAP 1.12 (shard)",
    "stream": "ROADMAP 1.7 (streams, graphs)",
    "disk cache": "ROADMAP 1.8 (compile cache)",
    "launch_batch": "ROADMAP 1.11 (serving)",
}
#: the reference's environment switches for the options above
_NOT_PORTED_ENV = {"CUPBOP_SANITIZE": "sanitize",
                   "CUPBOP_OPTIMIZE": "optimize",
                   "CUPBOP_CACHE_DIR": "disk cache"}

# The cache lives ON each kernel (a private dict attached to the
# KernelDef), so entries die with their kernel; the WeakSet enumerates
# kernels for cache_clear() and the LRU ring holds (weakref, key) pairs.
_CACHE_ATTR = "_launch_cache"
_CACHED_KERNELS: "weakref.WeakSet[KernelDef]" = weakref.WeakSet()
_LRU: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
_MAX_ENTRIES = max(1, int(os.environ.get("CUPBOP_CACHE_SIZE", "256")))


@dataclasses.dataclass
class CacheStats:
    """Counters of the launch cache (reset by ``cache_clear``)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0


_STATS = CacheStats()


def _refuse(**opts) -> None:
    for name, value in opts.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet: {NOT_PORTED[name]}")
    for var, name in _NOT_PORTED_ENV.items():
        if os.environ.get(var, "0") not in ("", "0"):
            raise NotImplementedError(
                f"{var} is set, but the {name} is not ported yet: "
                f"{NOT_PORTED[name]}")


def enable_disk_cache(path: str):
    """The reference's on-disk compile cache; not ported yet."""
    raise NotImplementedError(
        f"the disk cache is not ported yet: {NOT_PORTED['disk cache']}")


def launch_batch(kernel: KernelDef, **kwargs):
    """The reference's stacked batch launch; not ported yet."""
    raise NotImplementedError(
        f"launch_batch is not ported yet: {NOT_PORTED['launch_batch']}")


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


def _build(kernel: KernelDef, backend: str, grid: Dim3, block: Dim3,
           grain: int, dyn_shared, interpret: bool, names: tuple):
    entry = get_backend(backend)

    def fn(*leaves):
        glob = packing.unpack(leaves, names)  # kernel prologue (SIII-C.2)
        return entry.run(kernel, grid=grid, block=block, glob=glob,
                         grain=grain, dyn_shared=dyn_shared,
                         interpret=interpret)
    return fn


def _entry_for(kernel: KernelDef, grid: Dim3, block: Dim3, args: dict,
               backend: str, grain, dyn_shared, interpret: bool,
               pool) -> tuple[CompiledKernel, tuple]:
    """Resolve the launch specialization: cache hit or build."""
    grain = _resolve_grain(kernel, grain, pool, grid.size)
    args = memory_mod.resolve_launch_args(kernel, args)
    leaves, names = packing.pack(args)     # host prologue (SIII-C.2)
    shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)
    key = (backend, grid, block, grain, dyn_shared, interpret, names, shapes)
    per_kernel = _kernel_cache(kernel)
    entry = per_kernel.get(key)
    if entry is not None:
        _STATS.hits += 1
        _LRU.move_to_end((weakref.ref(kernel), key))
        return entry, leaves
    _STATS.misses += 1
    backend_entry = get_backend(backend)
    # surface UnsupportedKernel before anything runs (coverage probes)
    backend_entry.check(kernel, block)
    entry = CompiledKernel(
        kernel=kernel, backend=backend, grid=grid, block=block, key=key,
        fn=_build(kernel, backend, grid, block, grain, dyn_shared,
                  interpret, names))
    per_kernel[key] = entry
    _LRU[(weakref.ref(kernel), key)] = None
    _evict_to_bound()
    return entry, leaves


def _launch(kernel: KernelDef, grid: Dim3, block: Dim3, args: dict,
            backend: str, grain, dyn_shared, interpret: bool,
            pool) -> dict:
    _refuse()        # the reference's environment switches
    entry, leaves = _entry_for(kernel, grid, block, args, backend, grain,
                               dyn_shared, interpret, pool)
    out = entry(*leaves)
    # donated handle-bound buffers come back as the SAME handle, re-bound
    # to the kernel's output (the CUDA in-place view)
    return memory_mod.rebind_outputs(kernel, args, out)


def compiled(kernel: KernelDef, *, grid, block, args: dict,
             backend: str = "vector", grain: int | str = 1,
             dyn_shared: int | None = None, interpret: bool = True,
             pool: int | None = None, devices=None, shard_axis=None,
             optimize=None) -> CompiledKernel:
    """Resolve (or fetch) the launch specialization without running it:
    the ``cudaModuleGetFunction`` analogue."""
    _refuse(devices=devices, shard_axis=shard_axis, optimize=optimize)
    entry, _ = _entry_for(kernel, Dim3.of(grid), Dim3.of(block), args,
                          backend, grain, dyn_shared, interpret, pool)
    return entry


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """A kernel bound to its ``<<<grid, block, dyn_shared>>>``.

    Calling it launches: buffers go in as keyword arguments (or one
    positional dict) and the updated buffer dict comes back.  Options
    CUDA keeps out of the chevrons are set with :meth:`on`::

        out = kernel[(gx, gy), (bx, by)].on(backend="cuda")(t=t, p=p)
    """

    kernel: KernelDef
    grid: Dim3
    block: Dim3
    dyn_shared: int | None = None
    backend: str = "vector"
    grain: int | str = 1
    interpret: bool = True
    pool: int | None = None

    @classmethod
    def from_chevron(cls, kernel: KernelDef, config: tuple) -> "LaunchConfig":
        grid, block, *rest = config
        dyn_shared = rest[0] if len(rest) >= 1 else None
        _refuse(stream=rest[1] if len(rest) >= 2 else None)
        if dyn_shared is not None and not isinstance(dyn_shared, int):
            raise TypeError(
                f"kernel {kernel.name}: third chevron slot (dyn_shared) must "
                f"be an int or None, got {dyn_shared!r}")
        return cls(kernel=kernel, grid=Dim3.of(grid), block=Dim3.of(block),
                   dyn_shared=dyn_shared)

    def on(self, **overrides) -> "LaunchConfig":
        """Re-bind execution options: backend, grain, interpret, pool."""
        _refuse(**{k: v for k, v in overrides.items() if k in NOT_PORTED})
        allowed = {"backend", "grain", "interpret", "pool"}
        bad = set(overrides) - allowed - set(NOT_PORTED)
        if bad:
            raise TypeError(f"LaunchConfig.on() got unexpected options "
                            f"{sorted(bad)}; allowed: {sorted(allowed)}")
        return dataclasses.replace(
            self, **{k: v for k, v in overrides.items() if k in allowed})

    def __call__(self, args: dict | None = None, /, **buffers) -> dict:
        return _launch(self.kernel, self.grid, self.block,
                       {**(args or {}), **buffers}, self.backend, self.grain,
                       self.dyn_shared, self.interpret, self.pool)


def launch(kernel: KernelDef, *, grid, block, args: dict,
           backend: str = "vector", grain: int | str = 1,
           dyn_shared: int | None = None, interpret: bool = True,
           pool: int | None = None, devices=None, shard_axis=None,
           sanitize=None, optimize=None) -> dict:
    """Launch ``kernel`` over ``grid`` blocks of ``block`` threads.

    ``args`` maps global-buffer names to tensors (or ``DeviceBuffer``/
    ``ConstArray`` handles); returns the dict with the kernel's written
    buffers replaced.  ``grain`` may be an int, "average" or "aggressive"
    (paper SIV-A; ``pool`` = worker count).
    """
    _refuse(devices=devices, shard_axis=shard_axis, sanitize=sanitize,
            optimize=optimize)
    return _launch(kernel, Dim3.of(grid), Dim3.of(block), args, backend,
                   grain, dyn_shared, interpret, pool)
