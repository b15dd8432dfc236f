"""Warp-level functions (CUDA 9+ intrinsics) for the port's lowerings.

Every function takes values with a leading thread-chunk axis whose size
is a multiple of 32 (chunk == 32 under the loop lowering's warp mode;
chunk == block size under vector), reshapes it to ``[n_warps, 32, ...]``
and applies a gather, permutation or reduction along the lane axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel import WARP_SIZE, UnsupportedKernel


def _to_warps(val: torch.Tensor) -> torch.Tensor:
    n = val.shape[0]
    if n % WARP_SIZE != 0:
        raise UnsupportedKernel(
            f"warp op on chunk of {n} threads (not a multiple of "
            f"{WARP_SIZE})")
    return val.reshape((n // WARP_SIZE, WARP_SIZE) + tuple(val.shape[1:]))


def _flat(val: torch.Tensor) -> torch.Tensor:
    return val.reshape((val.shape[0] * val.shape[1],) + tuple(val.shape[2:]))


def _lanes(device) -> torch.Tensor:
    return torch.arange(WARP_SIZE, device=device)


def _lane_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a per-lane ``[32]`` tensor to broadcast against ``ndim``."""
    return t.reshape((1, WARP_SIZE) + (1,) * (ndim - 2))


def _gather_lanes(w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``w[warp, src[warp, lane, ...], ...]`` along the lane axis.

    ``src`` has shape ``[n_warps or 1, 32, ...]`` with at most ``w``'s
    rank; missing trailing axes broadcast.
    """
    idx = src.reshape(tuple(src.shape) + (1,) * (w.dim() - src.dim()))
    return torch.gather(w, 1, idx.expand(w.shape))


def shfl(val, src_lane):
    """__shfl_sync: every lane reads ``val`` from lane ``src_lane``.

    ``src_lane`` may be a scalar or a per-thread tensor of lane ids; both
    wrap modulo the warp width, as CUDA specifies, so lane 37 reads lane 5.
    """
    w = _to_warps(val)
    if not isinstance(src_lane, torch.Tensor) or src_lane.dim() == 0:
        lane = int(src_lane) % WARP_SIZE
        return _flat(w[:, lane:lane + 1].expand(w.shape))
    src = _to_warps(src_lane.long()) % WARP_SIZE
    return _flat(_gather_lanes(w, src))


def _keep_own(w, src):
    """Gather lane ``src`` where in the segment, else keep the own value."""
    ok = (src >= 0) & (src < WARP_SIZE)
    gathered = _gather_lanes(w, src.clamp(0, WARP_SIZE - 1))
    okb = ok.reshape(tuple(ok.shape) + (1,) * (w.dim() - ok.dim()))
    return torch.where(okb, gathered, w)


def _shfl_shift(val, delta, direction):
    w = _to_warps(val)
    src = (_lanes(w.device) + direction * delta).reshape(1, WARP_SIZE)
    # CUDA keeps the caller's own value when the source lane is out of range
    return _flat(_keep_own(w, src))


def shfl_up(val, delta):
    return _shfl_shift(val, delta, -1)


def shfl_down(val, delta):
    return _shfl_shift(val, delta, +1)


def shfl_xor(val, mask):
    """__shfl_xor_sync: lane ``i`` reads ``val`` from lane ``i ^ mask``.

    ``mask`` may be a scalar or a per-thread tensor of masks.  CUDA does
    not wrap the xor'd lane: outside the segment the caller keeps its own
    value.
    """
    w = _to_warps(val)
    lane = _lanes(w.device).reshape(1, WARP_SIZE)
    if not isinstance(mask, torch.Tensor) or mask.dim() == 0:
        src = lane ^ int(mask)
    else:
        m = _to_warps(mask.long())
        src = lane.reshape((1, WARP_SIZE) + (1,) * (m.dim() - 2)) ^ m
    return _flat(_keep_own(w, src))


def vote_all(pred):
    w = _to_warps(pred)
    return _flat(w.all(dim=1, keepdim=True).expand(w.shape))


def vote_any(pred):
    w = _to_warps(pred)
    return _flat(w.any(dim=1, keepdim=True).expand(w.shape))


def ballot(pred):
    """__ballot_sync: 32-bit mask of predicates, broadcast to every lane.

    Returned as ``int64`` holding the unsigned 32-bit mask (torch has
    few operations on ``uint32``); the reference returns ``uint32``.
    """
    w = _to_warps(pred).long()
    bits = w * _lane_view(torch.ones(WARP_SIZE, dtype=torch.long,
                                     device=w.device) << _lanes(w.device),
                          w.dim())
    return _flat(bits.sum(dim=1, keepdim=True).expand(w.shape))


def syncthreads_count(pred, block_dim: int):
    """``__syncthreads_count``: block-wide count of true predicates.

    The chunk must span the block: always under vector, and under the loop
    lowering exactly for 32-thread blocks in warp mode.  Larger blocks
    under loop raise :class:`UnsupportedKernel`.
    """
    n = pred.shape[0]
    if n != block_dim:
        raise UnsupportedKernel(
            f"__syncthreads_count needs the thread chunk ({n}) to span the "
            f"block ({block_dim}); under the loop lowering use 32-thread "
            f"blocks (warp mode) or the vector lowering")
    count = pred.to(torch.int32).sum(dim=0, keepdim=True, dtype=torch.int32)
    return count.expand((n,) + tuple(count.shape[1:]))


def _amax(w, dim, keepdim):
    return w.amax(dim=dim, keepdim=keepdim)


def _amin(w, dim, keepdim):
    return w.amin(dim=dim, keepdim=keepdim)


def _sum(w, dim, keepdim):
    return w.sum(dim=dim, keepdim=keepdim, dtype=w.dtype)


_REDUCERS = {"add": _sum, "max": _amax, "min": _amin}


def reduce(val, op="add"):
    """Butterfly warp reduction (the classic __shfl_xor tree, collapsed)."""
    w = _to_warps(val)
    return _flat(_REDUCERS[op](w, 1, True).expand(w.shape))
