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
"""
from __future__ import annotations

import torch

from repro_torch.core import index

#: combine modes accepted in ``KernelDef.combines`` (declarations kept
#: from the reference; the shard backend that reads them is not ported).
CROSS_SHARD_COMBINES = ("sum", "max", "min", "concat")


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
