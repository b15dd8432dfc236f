"""Sharded block scheduler: the launch grid spread over a pool of workers.

CuPBoP's threadblock is the unit that maps onto whatever parallel
hardware exists; the loop and vector lowerings run the whole grid on one
device, and this module is the multi-worker half (the reference's
``repro.core.lower_shard``, which spreads the grid over an XLA mesh).

* **partition** - the grid's linear block ids split into ``n`` contiguous
  ranges of ``per = ceil(n_blocks / n)`` (the tail masked);
* **per-shard execution** - shard ``s`` runs ``bid_start = s * per,
  count = per`` through an existing lowering (``lower_loop``, or
  ``lower_vector`` for ``shard_vector``) via its block-range view, so
  ``ctx.bid`` reads global ids.  Every shard runs against the launch-time
  heap: each gets its own copy of every written buffer, never another
  shard's writes;
* **combine** - each written buffer's partials merge as its
  ``KernelDef.combines`` declares (:func:`repro_torch.core.atomics
  .combine_partials`; ``"sum"`` by default), or, for ``"concat"``, each
  shard keeps only its own leading-axis rows.

The pool follows the heap's device.  On CUDA tensors it is the machine's
cards (``torch.cuda.device_count()``), shard ``s`` on ``cuda:s``, the
partials combined on the heap's device.  On CPU tensors it is
``CUPBOP_HOST_DEVICES`` host workers (default 1, read at every launch),
the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.  The shards run
one after another in the calling thread.  ``devices=`` caps the shard
count; ``shard_axis=`` has no mesh to name here and is kept as a label of
the launch's cache key.
"""
from __future__ import annotations

import os
import warnings

import torch

from repro_torch.core import atomics, lower_loop, lower_vector
from repro_torch.core import memory as memory_mod
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import KernelDef, UnsupportedKernel
from repro_torch.core.lower_vector import _device

DEFAULT_AXIS = "blocks"

#: the environment variable that sizes the pool of host workers
HOST_DEVICES_ENV = "CUPBOP_HOST_DEVICES"

_INNER = {"loop": lower_loop.run, "vector": lower_vector.run}


def pool_size(device) -> int:
    """Workers a launch over tensors on ``device`` can shard across."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    raw = os.environ.get(HOST_DEVICES_ENV, "1")
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{HOST_DEVICES_ENV}={raw!r} is not an integer")\
            from None
    if n < 1:
        raise ValueError(f"{HOST_DEVICES_ENV} must be >= 1, got {n}")
    return n


def resolve_devices(devices: int | None, n_blocks: int,
                    device="cpu") -> int:
    """Shard count for a launch over tensors on ``device``: the requested
    count (or the whole pool), capped by the grid."""
    avail = pool_size(device)
    n = avail if devices is None else int(devices)
    if n < 1:
        raise ValueError(f"devices must be >= 1, got {devices!r}")
    if n > avail:
        if torch.device(device).type == "cuda":
            how = (f"the pool on CUDA tensors is the machine's "
                   f"{avail} card(s) (torch.cuda.device_count())")
        else:
            how = (f"on the CPU set {HOST_DEVICES_ENV}={n} for a pool of "
                   f"{n} host workers")
        raise ValueError(
            f"{n} devices requested but only {avail} available; {how}")
    return min(n, n_blocks)


def combine_modes(kernel: KernelDef) -> dict[str, str]:
    """Each written buffer's combine mode; raises
    :class:`UnsupportedKernel` for an unknown mode, a mode declared on a
    buffer the kernel does not write, or a partial declaration."""
    modes = {name: kernel.combines.get(name, "sum")
             for name in kernel.writes}
    bad = {n: m for n, m in modes.items()
           if m not in atomics.CROSS_SHARD_COMBINES}
    if bad:
        raise UnsupportedKernel(
            f"kernel {kernel.name}: cross-shard combine mode(s) {bad} not "
            f"in {atomics.CROSS_SHARD_COMBINES}")
    stray = set(kernel.combines) - set(kernel.writes)
    if stray:
        raise UnsupportedKernel(
            f"kernel {kernel.name}: combines declared for non-written "
            f"buffer(s) {sorted(stray)} (writes: {tuple(kernel.writes)})")
    if kernel.combines:
        # all or nothing: a partial declaration is almost certainly a
        # forgotten buffer, and the implicit "sum" is exact only for
        # accumulation and zero-initialized writes
        missing = set(kernel.writes) - set(kernel.combines)
        if missing:
            raise UnsupportedKernel(
                f"kernel {kernel.name}: combines declares "
                f"{sorted(kernel.combines)} but is missing written "
                f"buffer(s) {sorted(missing)}; declare a combine mode for "
                f"every written buffer (use 'sum' for the default) or for "
                f"none")
    return modes


def _shard_device(heap: torch.device, s: int) -> torch.device:
    return torch.device("cuda", s) if heap.type == "cuda" else heap


def run(kernel: KernelDef, *, grid, block, glob, grain=1, dyn_shared=None,
        devices: int | None = None, shard_axis: str = DEFAULT_AXIS,
        inner: str = "loop") -> dict:
    """Execute the launch with its blocks sharded over the pool.

    ``glob`` holds plain tensors: the tracked-buffer wrappers
    (``DeviceBuffer``, ``ConstArray``) are checked and unwrapped on the
    :mod:`repro_torch.core.api` launch path, so a wrapper here is refused
    with that fix.
    """
    bad = [n for n, v in glob.items()
           if isinstance(v, (memory_mod.ConstArray,
                             memory_mod.DeviceBuffer))]
    if bad:
        raise TypeError(
            f"shard backend received wrapped buffer object(s) {sorted(bad)}"
            f"; launch through repro_torch.core.api (kernel[grid, block]"
            f"(...) or launch(...)) so handles are liveness-checked and "
            f"unwrapped")
    grid, block = Dim3.of(grid), Dim3.of(block)
    inner_run = _INNER[inner]
    modes = combine_modes(kernel)
    n_blocks = grid.size
    heap = _device(glob)
    n_dev = resolve_devices(devices, n_blocks, heap)
    if n_dev == 1:       # one worker: the inner lowering verbatim
        return inner_run(kernel, grid=grid, block=block, glob=glob,
                         grain=grain, dyn_shared=dyn_shared)
    per = -(-n_blocks // n_dev)

    # "concat" (owned slices) needs equal shard ranges and a leading axis
    # that rows-per-block divides; otherwise it degrades to "sum", which
    # rounds a float overwrite of large prior values, so it warns
    rows_per_block: dict[str, int] = {}
    for name, mode in list(modes.items()):
        if mode != "concat":
            continue
        rows = glob[name].shape[0] if glob[name].dim() else 0
        if n_blocks % n_dev == 0 and rows and rows % n_blocks == 0:
            rows_per_block[name] = rows // n_blocks
        else:
            warnings.warn(
                f"kernel {kernel.name}: buffer {name!r} declared "
                f"combines='concat' but grid {n_blocks} / devices {n_dev} "
                f"/ rows {rows} do not divide evenly; falling back to "
                f"'sum' (exact only for accumulation or zero-initialized "
                f"buffers - pad the grid or match the device count for "
                f"owned-slice combining)", stacklevel=2)
            modes[name] = "sum"

    partials: dict[str, list[torch.Tensor]] = {n: [] for n in kernel.writes}
    for s in range(n_dev):
        dev = _shard_device(heap, s)
        # the shard's own copy of the launch-time heap
        g = {n: (t.to(dev, copy=True) if n in modes else t.to(dev))
             for n, t in glob.items()}
        out = inner_run(kernel, grid=grid, block=block, glob=g,
                        grain=grain, dyn_shared=dyn_shared,
                        bid_start=s * per, count=per)
        for name in kernel.writes:
            part = out[name]
            if modes[name] == "concat":          # keep only the owned rows
                rpb = rows_per_block[name]
                part = part[s * per * rpb:(s + 1) * per * rpb]
            partials[name].append(part.to(heap))
    merged = dict(glob)
    for name in kernel.writes:
        if modes[name] == "concat":
            merged[name] = torch.cat(partials[name])
        else:
            merged[name] = atomics.combine_partials(
                modes[name], glob[name], partials[name])
    return merged
