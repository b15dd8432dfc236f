"""CUDA atomics for the port's loop and vector lowerings.

Those lowerings run blocks one after another and the threads of a chunk
in one vectorised update, so atomics become deterministic scatters:

* ``atomic_add/max/min`` are drop-mode scatter-reduces (duplicates
  accumulate; a negative index is dropped, never wrapped);
* ``atomic_cas``/``atomic_exch`` serialise the chunk in thread order and
  return the value each thread observed, CUDA's return-the-old-value
  contract under one fixed order;
* ``atomic_cas_first`` is the first-wins compare-and-swap.

The ``cuda`` backend's hand-written kernels use the card's own atomics,
whose order is not fixed.  Where the reference's order shows in a result,
the kernel reproduces it (see ``csrc/bfs_frontier.cu``).

**Cross-shard combining.**  The shard backends
(:mod:`repro_torch.core.lower_shard`) run each shard's block range
against the *launch-time* value of every written buffer, so two blocks on
different shards that hit one element each see only their own partial.
:func:`combine_partials` merges the partials as declared in
``KernelDef.combines``: ``"sum"`` adds the per-shard deltas back onto the
launch-time value (exact for cross-block ``atomicAdd`` and for disjoint
writes into zeroed buffers; a float overwrite of a large prior value
rounds through ``in + (out - in)``), ``"max"``/``"min"`` reduce the
partials elementwise, and ``"concat"`` (owned leading-axis rows) is
assembled by the shard backend itself.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import index

#: combine modes accepted in ``KernelDef.combines``.  sum/max/min reduce
#: the partials (:func:`combine_partials`); concat is structural and
#: handled by the shard backend.
CROSS_SHARD_COMBINES = ("sum", "max", "min", "concat")


def _lowest(t: torch.Tensor):
    if t.dtype == torch.bool:
        return False
    if t.dtype.is_floating_point:
        return -math.inf
    return torch.iinfo(t.dtype).min


def _highest(t: torch.Tensor):
    if t.dtype == torch.bool:
        return True
    if t.dtype.is_floating_point:
        return math.inf
    return torch.iinfo(t.dtype).max


def combine_partials(mode: str, before: torch.Tensor,
                     afters: list[torch.Tensor]) -> torch.Tensor:
    """Merge one written buffer's per-shard partials.

    ``before`` is the buffer's launch-time value and ``afters[s]`` its
    value once shard ``s`` ran its block range against ``before``.  The
    reference reduces inside ``shard_map`` with a collective; with no
    mesh, this computes what that collective computes on the host
    platform, folding the shards in order, shard 0 first:

    * ``"sum"``: ``before + (((0 + d_0) + d_1) + ...)`` with
      ``d_s = afters[s] - before``.  An untouched ``-0.0`` comes back
      ``+0.0`` and an untouched ``±inf`` NaN (``inf - inf``);
    * ``"max"``/``"min"``: starting from ``-inf``/``+inf`` (an integer
      type's extremes), a shard's value replaces the running one only
      when strictly greater/less, so NaN partials are passed over (all-NaN
      gives the start value) and a ``±0`` tie keeps the earlier shard's.
    """
    if mode == "sum":
        acc = torch.zeros_like(before)
        for after in afters:
            acc = acc + (after - before)
        return before + acc
    if mode == "max":
        acc = torch.full_like(before, _lowest(before))
        for after in afters:
            acc = torch.where(after > acc, after, acc)
        return acc
    if mode == "min":
        acc = torch.full_like(before, _highest(before))
        for after in afters:
            acc = torch.where(after < acc, after, acc)
        return acc
    raise ValueError(
        f"cross-shard combine mode {mode!r} is not a collective reduction; "
        f"reducible modes: sum/max/min (concat is assembled by the shard "
        f"backend from each shard's owned rows, not here)")


def _drop_negative(arr, idx):
    """Rewrite negative indices to the past-the-end drop sentinel.

    A scatter wraps ``-1`` onto the last element, exactly the left-halo
    index a CUDA kernel expects to be discarded, so negatives become
    ``arr.shape[0]`` and drop.
    """
    idx = torch.as_tensor(idx, device=arr.device).long()
    return torch.where(idx < 0, arr.shape[0], idx)


def atomic_add(arr, idx, val):
    return index.put(arr, _drop_negative(arr, idx), val, "add")


def atomic_max(arr, idx, val):
    return index.put(arr, _drop_negative(arr, idx), val, "max")


def atomic_min(arr, idx, val):
    return index.put(arr, _drop_negative(arr, idx), val, "min")


def _first_occurrence(idx):
    """Mask of chunk positions that are the first occurrence of their index."""
    n = idx.shape[0]
    eq = idx[None, :] == idx[:, None]                       # [t, t']
    lower = torch.ones((n, n), dtype=torch.bool,
                       device=idx.device).tril(diagonal=-1)
    return ~(eq & lower).any(dim=1)


def _serial_rmw(arr, idx, update):
    """Serialise a read-modify-write over the thread chunk in thread order.

    ``update(t, cur)`` returns the value to store at ``idx[t]`` given the
    currently observed ``cur``.  Indices outside ``[0, arr.shape[0])``
    mark inactive threads: they observe a clamped read and store nothing.
    Returns ``(new_arr, old)`` where ``old[t]`` is what thread ``t`` saw.
    """
    idx = torch.as_tensor(idx, device=arr.device).long()
    size = arr.shape[0]
    a = arr.clone()
    old = torch.zeros(idx.shape, dtype=arr.dtype, device=arr.device)
    for t, i in enumerate(idx.tolist()):
        safe = min(max(i, 0), size - 1)
        cur = a[safe].clone()
        if 0 <= i < size:
            a[safe] = update(t, cur)
        old[t] = cur
    return a, old


def atomic_cas(arr, idx, cmp, val):
    """``atomicCAS``: returns ``(new_arr, old)`` with serialised semantics.

    Each thread, in thread order, swaps ``val[t]`` in iff the value its
    predecessors left equals ``cmp[t]``; ``old[t] == cmp[t]`` tells it
    whether it performed the store (Rodinia BFS's visited-flag claim).
    Inactive threads pass an out-of-range index or a ``cmp`` that cannot
    match.
    """
    shape = torch.as_tensor(idx).shape
    cmp = torch.as_tensor(cmp, device=arr.device).expand(shape)
    val = torch.as_tensor(val, device=arr.device).to(arr.dtype).expand(shape)
    return _serial_rmw(arr, idx,
                       lambda t, cur: torch.where(cur == cmp[t], val[t], cur))


def atomic_exch(arr, idx, val):
    """``atomicExch``: returns ``(new_arr, old)``, serialised thread order;
    the last duplicate's value survives."""
    shape = torch.as_tensor(idx).shape
    val = torch.as_tensor(val, device=arr.device).to(arr.dtype).expand(shape)
    return _serial_rmw(arr, idx, lambda t, cur: val[t])


def atomic_cas_first(arr, idx, cmp, val):
    """Compare-and-swap, first-wins across duplicate indices.

    For each ``idx[t]``: if ``arr[idx[t]] == cmp[t]`` the value of the
    lowest such ``t`` is stored.  Out-of-range indices store nothing.
    Returns only the updated array.
    """
    idx = torch.as_tensor(idx, device=arr.device).long()
    n = arr.shape[0]
    active = (idx >= 0) & (idx < n)
    is_first = _first_occurrence(idx)
    old = arr[idx.clamp(0, n - 1)]
    ok = (old == torch.as_tensor(cmp, device=arr.device)) & is_first & active
    safe_idx = torch.where(ok, idx, n)                      # OOB drops
    val = torch.as_tensor(val, device=arr.device)
    return index.put(arr, safe_idx, torch.where(ok, val, 0))
