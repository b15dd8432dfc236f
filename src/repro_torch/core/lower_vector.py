"""SPMD-to-MPMD **vector** lowering.

The whole thread block is one chunk: the thread axis is the leading
dimension of every private tensor, and barriers (stage boundaries) are
program-order sequence points.  Blocks run in a Python fetch x grain loop
(paper SIV-A), one after another, so cross-block atomics see a fixed
order.  It runs on any device; the ``cuda`` backend replaces it on the
card (:mod:`repro_torch.core.lower_cuda`).
"""
from __future__ import annotations

import torch

from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import (
    BlockState,
    Ctx,
    KernelDef,
    block_range_limit,
    check_priv_chunk,
)


def _device(glob: dict):
    return next(iter(glob.values())).device if glob else torch.device("cpu")


def run_block(kernel: KernelDef, bid: int, *, block, grid, glob,
              dyn_shared=None) -> dict:
    block, grid = Dim3.of(block), Dim3.of(grid)
    device = _device(glob)
    st = BlockState(priv={}, shared=kernel.init_shared(dyn_shared, device),
                    glob=glob)
    ctx = Ctx(bid=bid,
              tid=torch.arange(block.size, dtype=torch.int32, device=device),
              block_dim=block.size, grid_dim=grid.size, backend="vector",
              uses_warp=True, block_dim3=block, grid_dim3=grid)
    for si, stage in enumerate(kernel.stages):
        st = stage(ctx, st)
        check_priv_chunk(st.priv, block.size, kernel.name, si)
    return st.glob


def run(kernel: KernelDef, *, grid, block, glob, grain=1, dyn_shared=None,
        bid_start=0, count=None) -> dict:
    """``bid_start``/``count`` select a block-range view of the grid:
    blocks keep their global linear id, ids past ``grid.size`` are
    skipped."""
    grid, block = Dim3.of(grid), Dim3.of(block)
    count = grid.size if count is None else count
    limit = block_range_limit(bid_start, count, grid.size)
    for f in range(-(-count // grain)):
        for i in range(grain):
            bid = bid_start + f * grain + i
            if bid < limit:
                glob = run_block(kernel, bid, block=block, grid=grid,
                                 glob=glob, dyn_shared=dyn_shared)
    return glob
