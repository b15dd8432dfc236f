"""Paper-faithful SPMD-to-MPMD **loop** lowering (CuPBoP SIII-B.3, Fig. 2/4).

* one function per CUDA block (block fusion);
* **loop fission at barriers**: each stage gets its own loop over thread
  chunks (Loop1/Loop2 of the paper's Fig. 4);
* **register demotion**: thread-private values that live across a barrier
  are stored to ``[block_size, ...]`` tensors between stage loops and
  re-sliced inside the next loop;
* **two-level nesting for warp-level kernels** (COX): the outer loop runs
  over warps (chunk = 32 lanes), the lanes are the vector axis;
* capability flags reproduce the Table-II coverage differences:
  ``allow_fission=False`` is a naive translator that cannot split at
  ``__syncthreads`` (MCUDA without fission), ``allow_warp=False`` is
  DPC++/HIP-CPU's missing warp-shuffle support.
"""
from __future__ import annotations

import torch

from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import (
    WARP_SIZE,
    BlockState,
    Ctx,
    KernelDef,
    UnsupportedKernel,
    block_range_limit,
    check_priv_chunk,
    tree_map,
)
from repro_torch.core.lower_vector import _device


def check(kernel: KernelDef, block, *, allow_fission=True, allow_warp=True):
    """Raise :class:`UnsupportedKernel` if this variant cannot express
    ``kernel``; returns the thread-chunk size otherwise."""
    block = Dim3.of(block)
    if len(kernel.stages) > 1 and not allow_fission:
        raise UnsupportedKernel(
            f"kernel {kernel.name}: __syncthreads requires loop fission "
            f"(naive lowering cannot express it)")
    if kernel.uses_warp and not allow_warp:
        raise UnsupportedKernel(
            f"kernel {kernel.name}: warp-level functions unsupported by this "
            f"lowering (cf. Table II, Crystal q11-q13)")
    chunk = WARP_SIZE if kernel.uses_warp else 1
    if block.size % chunk != 0:
        raise UnsupportedKernel(
            f"kernel {kernel.name}: block {block.size} not a multiple of "
            f"{chunk}")
    return chunk


def _stage_loop(stage, stage_idx, kernel, bid, block, grid, chunk,
                priv_in, shared, glob):
    """One fissioned loop: run ``stage`` for every thread chunk in order.

    ``priv_in`` is the demoted ``[block, ...]`` dict from the previous
    stage (None for stage 0).  Returns (priv_out demoted, shared, glob).
    """
    device = _device(glob)
    outs = []
    for c in range(block.size // chunk):
        tid = c * chunk + torch.arange(chunk, dtype=torch.int32,
                                       device=device)
        priv_c = ({} if priv_in is None else
                  tree_map(lambda a, c=c: a[c * chunk:(c + 1) * chunk],
                           priv_in))
        ctx = Ctx(bid=bid, tid=tid, block_dim=block.size,
                  grid_dim=grid.size, backend="loop",
                  uses_warp=kernel.uses_warp, block_dim3=block,
                  grid_dim3=grid)
        st = stage(ctx, BlockState(priv=priv_c, shared=shared, glob=glob))
        check_priv_chunk(st.priv, chunk, kernel.name, stage_idx)
        outs.append(st.priv)
        shared, glob = st.shared, st.glob
    priv_out = tree_map(lambda *parts: torch.cat(parts), *outs)
    return priv_out, shared, glob


def run_block(kernel: KernelDef, bid: int, *, block, grid, glob,
              dyn_shared=None, allow_fission=True, allow_warp=True) -> dict:
    """Execute one CUDA block under the loop lowering; returns new glob."""
    block, grid = Dim3.of(block), Dim3.of(grid)
    chunk = check(kernel, block, allow_fission=allow_fission,
                  allow_warp=allow_warp)
    shared = kernel.init_shared(dyn_shared, _device(glob))
    # barrier-fission optimizer (core/optimize.py): shared buffers proven
    # dead after a stage leave the carried state, so later stage loops do
    # not thread them through
    drop = dict(getattr(kernel, "drop_shared", ()) or ())
    priv = None
    for si, stage in enumerate(kernel.stages):
        priv, shared, glob = _stage_loop(stage, si, kernel, bid, block, grid,
                                         chunk, priv, shared, glob)
        dead = drop.get(si)
        if dead:
            shared = {n: v for n, v in shared.items() if n not in dead}
    return glob


def run(kernel: KernelDef, *, grid, block, glob, grain=1, dyn_shared=None,
        allow_fission=True, allow_warp=True, bid_start=0,
        count=None) -> dict:
    """Full launch: fetch-loop x grain-loop over blocks (paper Fig. 5/6).

    ``bid_start``/``count`` select a block-range view; blocks keep their
    global linear id.
    """
    grid, block = Dim3.of(grid), Dim3.of(block)
    check(kernel, block, allow_fission=allow_fission, allow_warp=allow_warp)
    count = grid.size if count is None else count
    limit = block_range_limit(bid_start, count, grid.size)
    for f in range(-(-count // grain)):
        for i in range(grain):
            bid = bid_start + f * grain + i
            if bid < limit:
                glob = run_block(kernel, bid, block=block, grid=grid,
                                 glob=glob, dyn_shared=dyn_shared,
                                 allow_fission=allow_fission,
                                 allow_warp=allow_warp)
    return glob
