"""JAX's out-of-range index rules, on torch tensors.

The suite's stages lean on how JAX treats indices that fall outside an
array, and torch raises where JAX does not:

* a **gather** (``x[i]``) wraps a negative index once (``-1`` reads the
  last element) and then clamps what is still out of range, so
  ``x[[-1, 7, -9]]`` on five elements reads ``x[4], x[4], x[0]``;
* a **scatter** (``x.at[i].set/add/max/min(v, mode="drop")``) wraps a
  negative index once and then drops every update whose index is still
  out of range - the suite's ``OOB = 1 << 30`` sentinel never reaches a
  torch index op;
* duplicate ``set`` indices resolve **last wins** (the order JAX gives on
  the CPU); here that order is fixed explicitly, so it holds on CUDA
  tensors too, where ``index_put_`` leaves duplicates unordered.

Tuple indices (``score.at[i, j]``, ``s.at[ty + 1, tx + 1]``) follow the
same rules per axis.  Every function returns a new tensor and leaves its
input untouched, as JAX's functional updates do.
"""
from __future__ import annotations

import math

import torch


def _as_index(i, device) -> torch.Tensor:
    return torch.as_tensor(i, device=device).long()


def take(arr: torch.Tensor, *idx) -> torch.Tensor:
    """``arr[idx]`` with JAX gather rules: wrap negatives once, then clamp.

    Fewer indices than dimensions select whole trailing dimensions.
    """
    if len(idx) > arr.dim():
        raise IndexError(f"{len(idx)} indices for a {arr.dim()}-d tensor")
    parts = []
    for i, size in zip(idx, arr.shape, strict=False):
        i = _as_index(i, arr.device)
        i = torch.where(i < 0, i + size, i)
        parts.append(i.clamp(0, size - 1))
    return arr[tuple(parts)]


def put(arr: torch.Tensor, idx, val, op: str = "set") -> torch.Tensor:
    """``arr.at[idx].<op>(val, mode="drop")`` with JAX scatter rules.

    ``idx`` is one index (int or tensor) or a tuple of them; ``op`` is
    ``set``, ``add``, ``max`` or ``min``.  ``val`` broadcasts to the
    indexed shape and is cast to ``arr``'s dtype.
    """
    parts = idx if isinstance(idx, tuple) else (idx,)
    k = len(parts)
    if k > arr.dim():
        raise IndexError(f"{k} indices for a {arr.dim()}-d tensor")
    lead, trail = arr.shape[:k], arr.shape[k:]
    parts = torch.broadcast_tensors(*(_as_index(i, arr.device)
                                      for i in parts))
    lin = torch.zeros(parts[0].shape, dtype=torch.long, device=arr.device)
    ok = torch.ones(parts[0].shape, dtype=torch.bool, device=arr.device)
    for i, size in zip(parts, lead, strict=True):
        i = torch.where(i < 0, i + size, i)
        ok &= (i >= 0) & (i < size)
        lin = lin * size + i
    val = torch.as_tensor(val, device=arr.device).to(arr.dtype)
    val = val.expand(tuple(lin.shape) + tuple(trail))
    lin, val = lin[ok], val[ok]
    flat = arr.reshape((math.prod(lead),) + tuple(trail)).clone()
    if op == "set":
        # last wins: keep, for each target, only its final update
        pos = torch.arange(lin.numel(), device=arr.device)
        last = torch.full((flat.shape[0],), -1, dtype=torch.long,
                          device=arr.device)
        last.scatter_reduce_(0, lin, pos, "amax")
        keep = last[lin] == pos
        flat.index_put_((lin[keep],), val[keep])
    elif op == "add":
        flat.index_add_(0, lin, val)
    elif op in ("max", "min"):
        where = lin.reshape((-1,) + (1,) * len(trail)).expand(val.shape)
        flat.scatter_reduce_(0, where, val, "a" + op)
    else:
        raise ValueError(f"unknown scatter op {op!r}; expected "
                         f"set | add | max | min")
    return flat.reshape(arr.shape)
