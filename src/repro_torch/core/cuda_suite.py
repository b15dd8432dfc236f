"""CUDA-style kernel suite of the port: the reference's 23 entries, the
eleven Rodinia ones and twelve textbook ones.

Each entry is a kernel (two for srad_step, nn and kmeans) written in the
port's IR (stages over :class:`~repro_torch.core.kernel.Ctx`), a native
descriptor naming its hand-written CUDA kernel for the ``cuda`` backend,
and a NumPy oracle:

| kernel         | counterpart   | features exercised                              |
|----------------|---------------|-------------------------------------------------|
| vecadd         | Listing 1     | plain SPMD                                      |
| reverse        | Listing 3     | extern __shared__ sized by the launch, barrier  |
| histogram      | Hetero-Mark HIST | global integer atomics, strided access       |
| reduce_shared  | reductions    | barrier tree                                    |
| reduce_warp    | Crystal q11-q13 | __shfl_xor_sync butterflies                   |
| matmul_tiled   | lud/gemm      | shared tiles, register accumulator across 2k/8 barriers |
| stencil1d      | hotspot (1-D) | __shared__ halo loaded by the edge threads      |
| stencil2d      | hotspot       | 2-D dim3 grid x block, 2-D shared halo          |
| softmax_row    | attention primitive | one block per row, max and sum over shared |
| scan_block     | pathfinder/scan | Hillis-Steele scan, a register across 2 log2(block) barriers |
| transpose_tiled | SVI-C reordering | shared-staged 8x8 tile transpose            |
| pixel_pipeline | srad extract/compress | per-thread shared cell, two removable barriers |
| bfs_frontier   | bfs           | atomicCAS, atomicAdd, __syncthreads_count, const, stop-flag chain |
| pathfinder     | pathfinder    | __shared__ halo, barrier, row chain             |
| needle_nw      | nw            | anti-diagonal wavefront chain                   |
| hotspot        | hotspot       | 2-D dim3, 2-D shared halo, const, ping-pong chain |
| srad_step      | srad          | barrier-tree partials folded by a 2-D stencil kernel, two-kernel chain |
| nn             | nn            | cane record files, lexicographic arg-min tree, two-kernel top-k chain |
| kmeans         | kmeans        | contended float atomicAdd, two-kernel chain with a stop flag |
| backprop_layer | backprop      | barrier-tree reduction, const, owned-slice writes |
| lud_diag       | lud           | 2-D shared tile, b-1 barrier-separated steps    |
| lavamd         | lavaMD        | neighbour-list gather into shared, register accumulator across barriers |
| streamcluster  | streamcluster | contended atomicAdd, first-wins atomicCAS claims |

:func:`build_suite` returns them in the reference's order at the
reference's sizes.  bfs_frontier to kmeans are launch chains; the others
are single launches.  ``make_args`` and ``reference`` are NumPy, with
the reference package's inputs for the same generator (the builders take
size keywords whose defaults are the reference's sizes: ``build_suite(1)``'s
for the twelve textbook entries, which the reference defines inline
there).  The BFS and NW oracles are vectorised (by level and by
anti-diagonal) so they stay fast at Rodinia sizes; they compute the same
values as the reference's loops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import carry
from repro_torch.core import index, rodinia_io
from repro_torch.core.api import launch
from repro_torch.core.kernel import (
    ChainStats,
    ChainStep,
    KernelDef,
    LaunchChain,
    Native,
)
from repro_torch.core.streams import Stream
from repro_torch.x64 import canonical_dtype

OOB = 1 << 30  # out-of-bounds sentinel for drop-mode stores


def _gid(ctx):
    return ctx.bid * ctx.block_dim + ctx.tid


def _where(cond, a, b):
    """``jnp.where`` over index values: int64, on ``cond``'s device."""
    return torch.where(cond, torch.as_tensor(a, device=cond.device),
                       torch.as_tensor(b, device=cond.device))


# --------------------------------------------------------------------------
# vecadd (paper Listing 1)
# --------------------------------------------------------------------------
def make_vecadd(n: int) -> KernelDef:
    """dtype-agnostic stages; the native kernel takes float32 only."""
    def stage(ctx, st):
        gid = _gid(ctx)
        val = index.take(st.glob["a"], gid) + index.take(st.glob["b"], gid)
        return st.set_glob(c=index.put(st.glob["c"], _where(gid < n, gid, OOB),
                                       val))

    return KernelDef("vecadd", (stage,), writes=("c",),
                     reads=("a", "b", "c"), est_block_work=3e2,
                     native=Native.of("vecadd", n=n))


# --------------------------------------------------------------------------
# reverse (paper Listing 3: extern __shared__, one __syncthreads).  The
# shared array's extent is the launch's dyn_shared slot; ``n`` is the length
# of ``d``.
# --------------------------------------------------------------------------
def make_reverse(n: int) -> KernelDef:
    def load(ctx, st):
        s = index.put(st.shared["s"], ctx.tid,
                      index.take(st.glob["d"], ctx.tid))
        return st.set_shared(s=s)

    def store(ctx, st):
        ns = st.shared["s"].shape[0]
        d = index.put(st.glob["d"], ctx.tid,
                      index.take(st.shared["s"], ns - ctx.tid - 1))
        return st.set_glob(d=d)

    return KernelDef(
        "reverse", (load, store), writes=("d",), reads=("d",),
        shared={"s": ((-1,), torch.int32)}, est_block_work=2e2,
        native=Native.of("reverse", n=n),
    )


# --------------------------------------------------------------------------
# histogram (Hetero-Mark HIST; GPU-coalesced stride of Fig. 10a by default)
# --------------------------------------------------------------------------
def make_histogram(n: int, nbins: int, total_threads: int,
                   layout: str = "coalesced") -> KernelDef:
    if layout not in ("coalesced", "contiguous"):
        raise ValueError(f"histogram: unknown layout {layout!r}")
    iters = -(-n // total_threads)

    def stage(ctx, st):
        x, hist = st.glob["x"], st.glob["hist"]
        gid = _gid(ctx)
        for k in range(iters):
            if layout == "coalesced":      # GPU-friendly large stride
                idx = gid + k * total_threads
            else:                          # CPU-friendly contiguous (Fig 10c)
                idx = gid * iters + k
            v = index.take(x, idx.clamp(max=n - 1))
            hist = index.put(hist, _where(idx < n, v, OOB), 1, op="add")
        return st.set_glob(hist=hist)

    return KernelDef(
        f"histogram_{layout}", (stage,), writes=("hist",),
        reads=("x", "hist"), est_block_work=3e2 * iters,
        native=Native.of(f"histogram_{layout}", n=n, nbins=nbins,
                         total_threads=total_threads))


# --------------------------------------------------------------------------
# reduce_shared: classic barrier-tree block reduction (log2(block) stages)
# --------------------------------------------------------------------------
def make_reduce_shared(n: int, block: int,
                       dtype=torch.float32) -> KernelDef:
    if block < 1 or block & (block - 1):
        raise ValueError(f"reduce_shared: block must be a power of two, got "
                         f"{block}")

    def load(ctx, st):
        gid = _gid(ctx)
        v = torch.where(gid < n, index.take(st.glob["x"], gid.clamp(max=n - 1)),
                        0.0)
        return st.set_shared(s=index.put(st.shared["s"], ctx.tid, v))

    def make_level(offset):
        def level(ctx, st):
            s = st.shared["s"]
            mine = index.take(s, ctx.tid)
            new = torch.where(ctx.tid < offset,
                              mine + index.take(s, ctx.tid + offset), mine)
            return st.set_shared(s=index.put(s, ctx.tid, new))
        return level

    def store(ctx, st):
        idx = _where(ctx.tid == 0, ctx.bid, OOB)
        return st.set_glob(out=index.put(st.glob["out"], idx,
                                         st.shared["s"][0]))

    stages = [load]
    off = block // 2
    while off >= 1:
        stages.append(make_level(off))
        off //= 2
    stages.append(store)
    return KernelDef(
        "reduce_shared", tuple(stages), writes=("out",), reads=("x", "out"),
        shared={"s": ((block,), dtype)}, est_block_work=block * 8.0,
        native=Native.of("reduce_shared", n=n, nthreads=block),
    )


# --------------------------------------------------------------------------
# reduce_warp: shuffle-based reduction (warp-level features; COX/CuPBoP only)
# --------------------------------------------------------------------------
def make_reduce_warp(n: int, block: int, dtype=torch.float32) -> KernelDef:
    nwarps = block // 32

    def warp_phase(ctx, st):
        gid = _gid(ctx)
        val = torch.where(gid < n,
                          index.take(st.glob["x"], gid.clamp(max=n - 1)), 0.0)
        for off in (16, 8, 4, 2, 1):
            val = val + ctx.shfl_xor(val, off)
        idx = _where(ctx.lane == 0, ctx.warp, OOB)
        return st.with_priv({"v": val}).set_shared(
            s=index.put(st.shared["s"], idx, val))

    def final_phase(ctx, st):
        s = st.shared["s"]
        v = torch.where(ctx.tid < nwarps,
                        index.take(s, ctx.tid.clamp(max=nwarps - 1)), 0.0)
        for off in (16, 8, 4, 2, 1):
            v = v + ctx.shfl_xor(v, off)
        idx = _where(ctx.tid == 0, ctx.bid, OOB)
        return st.with_priv({}).set_glob(
            out=index.put(st.glob["out"], idx, v))

    return KernelDef(
        "reduce_warp", (warp_phase, final_phase), writes=("out",),
        reads=("x", "out"),
        shared={"s": ((nwarps,), dtype)}, uses_warp=True,
        est_block_work=block * 4.0,
        native=Native.of("reduce_warp", n=n, nthreads=block),
    )


# --------------------------------------------------------------------------
# matmul_tiled: shared-memory tiled GEMM; acc is a register demoted across
# 2*KT barriers (the hard case for fission correctness)
# --------------------------------------------------------------------------
def make_matmul_tiled(m: int, n: int, k: int, tile: int = 8,
                      dtype=torch.float32) -> KernelDef:
    if m % tile or n % tile or k % tile:
        raise ValueError(f"matmul_tiled: m, n, k = {m}, {n}, {k} must be "
                         f"multiples of the tile {tile}")
    kt = k // tile
    ntiles_n = n // tile

    def coords(ctx):
        ty, tx = ctx.tid // tile, ctx.tid % tile
        by, bx = ctx.bid // ntiles_n, ctx.bid % ntiles_n
        return ty, tx, by * tile + ty, bx * tile + tx

    def init(ctx, st):
        return st.with_priv({"acc": torch.zeros(
            ctx.tid.shape, dtype=canonical_dtype(dtype),
            device=ctx.tid.device)})

    def make_load(kk):
        def load(ctx, st):
            ty, tx, row, col = coords(ctx)
            sa = index.put(st.shared["sa"], (ty, tx),
                           index.take(st.glob["a"], row, kk * tile + tx))
            sb = index.put(st.shared["sb"], (ty, tx),
                           index.take(st.glob["b"], kk * tile + ty, col))
            return st.set_shared(sa=sa, sb=sb)
        return load

    def compute(ctx, st):
        ty, tx, _, _ = coords(ctx)
        sa, sb = st.shared["sa"], st.shared["sb"]
        acc = st.priv["acc"] + torch.einsum(
            "ti,it->t", index.take(sa, ty), sb[:, tx.long()])
        return st.with_priv({"acc": acc})

    def store(ctx, st):
        _, _, row, col = coords(ctx)
        c = index.put(st.glob["c"], (row, col), st.priv["acc"])
        return st.with_priv({}).set_glob(c=c)

    stages = [init]
    for kk in range(kt):
        stages += [make_load(kk), compute]
    stages.append(store)
    native = (Native.of("matmul_tiled", m=m, n=n, k=k)
              if tile == 8 else None)
    return KernelDef(
        "matmul_tiled", tuple(stages), writes=("c",), reads=("a", "b", "c"),
        shared={"sa": ((tile, tile), dtype),
                "sb": ((tile, tile), dtype)},
        est_block_work=tile * tile * k * 2.0,
        native=native,
    )


# --------------------------------------------------------------------------
# stencil1d (hotspot-like 3-point stencil with a shared halo)
# --------------------------------------------------------------------------
def make_stencil1d(n: int, block: int, dtype=torch.float32) -> KernelDef:
    def load(ctx, st):
        gid = _gid(ctx)
        x = st.glob["x"]
        s = index.put(st.shared["s"], ctx.tid + 1,
                      index.take(x, gid.clamp(0, n - 1)))
        left = index.take(x, (gid - 1).clamp(0, n - 1))
        right = index.take(x, (gid + 1).clamp(0, n - 1))
        s = index.put(s, _where(ctx.tid == 0, 0, OOB), left)
        s = index.put(s, _where(ctx.tid == block - 1, block + 1, OOB), right)
        return st.set_shared(s=s)

    def compute(ctx, st):
        gid = _gid(ctx)
        s = st.shared["s"]
        val = (0.25 * index.take(s, ctx.tid) + 0.5 * index.take(s, ctx.tid + 1)
               + 0.25 * index.take(s, ctx.tid + 2))
        return st.set_glob(y=index.put(st.glob["y"], _where(gid < n, gid, OOB),
                                       val))

    return KernelDef(
        "stencil1d", (load, compute), writes=("y",), reads=("x", "y"),
        shared={"s": ((block + 2,), dtype)}, est_block_work=block * 6.0,
        native=Native.of("stencil1d", n=n, nthreads=block),
    )


# --------------------------------------------------------------------------
# stencil2d (hotspot-style 5-point stencil; 2-D grid x 2-D block via dim3)
# --------------------------------------------------------------------------
def make_stencil2d(h: int, w: int, tile_y: int = 8,
                   tile_x: int = 8) -> KernelDef:
    """``blockIdx``/``threadIdx`` are genuinely 2-D (read through
    ``ctx.bid3``/``ctx.tid3``), with a shared halo tile."""

    def load(ctx, st):
        tx, ty, _ = ctx.tid3
        bx, by, _ = ctx.bid3
        row, col = by * tile_y + ty, bx * tile_x + tx
        x = st.glob["x"]

        def at(r, c):
            return index.take(x, r.clamp(0, h - 1), c.clamp(0, w - 1))

        s = index.put(st.shared["s"], (ty + 1, tx + 1), at(row, col))
        # boundary threads fetch the four halo edges
        s = index.put(s, (_where(ty == 0, 0, OOB), tx + 1), at(row - 1, col))
        s = index.put(s, (_where(ty == tile_y - 1, tile_y + 1, OOB), tx + 1),
                      at(row + 1, col))
        s = index.put(s, (ty + 1, _where(tx == 0, 0, OOB)), at(row, col - 1))
        s = index.put(s, (ty + 1, _where(tx == tile_x - 1, tile_x + 1, OOB)),
                      at(row, col + 1))
        return st.set_shared(s=s)

    def compute(ctx, st):
        tx, ty, _ = ctx.tid3
        bx, by, _ = ctx.bid3
        row, col = by * tile_y + ty, bx * tile_x + tx
        s = st.shared["s"]
        val = 0.2 * (index.take(s, ty + 1, tx + 1) + index.take(s, ty, tx + 1)
                     + index.take(s, ty + 2, tx + 1)
                     + index.take(s, ty + 1, tx)
                     + index.take(s, ty + 1, tx + 2))
        idx = _where((row < h) & (col < w), row, OOB)
        return st.set_glob(y=index.put(st.glob["y"], (idx, col), val))

    native = (Native.of("stencil2d", h=h, w=w)
              if (tile_y, tile_x) == (8, 8) else None)
    return KernelDef(
        "stencil2d", (load, compute), writes=("y",), reads=("x", "y"),
        shared={"s": ((tile_y + 2, tile_x + 2), torch.float32)},
        est_block_work=tile_y * tile_x * 10.0,
        native=native,
    )


# --------------------------------------------------------------------------
# softmax_row: one block per row of x[rows, block], two barriers (max, sum)
# --------------------------------------------------------------------------
def make_softmax_row(rows: int, block: int,
                     dtype=torch.float32) -> KernelDef:
    def load(ctx, st):
        v = index.take(st.glob["x"], ctx.bid, ctx.tid)
        return st.set_shared(s=index.put(st.shared["s"], ctx.tid, v))

    def exps(ctx, st):
        s = st.shared["s"]
        m = torch.max(s)                     # every thread reads all of shared
        p = torch.exp(index.take(s, ctx.tid) - m)
        return st.set_shared(p=index.put(st.shared["p"], ctx.tid, p))

    def normalize(ctx, st):
        p = st.shared["p"]
        denom = torch.sum(p)
        return st.set_glob(y=index.put(st.glob["y"], (ctx.bid, ctx.tid),
                                       index.take(p, ctx.tid) / denom))

    return KernelDef(
        "softmax_row", (load, exps, normalize), writes=("y",),
        reads=("x", "y"),
        shared={"s": ((block,), dtype), "p": ((block,), dtype)},
        est_block_work=block * 10.0,
        native=Native.of("softmax_row", rows=rows, nthreads=block),
    )


# --------------------------------------------------------------------------
# scan_block: Hillis-Steele inclusive prefix sum (2 stages per level)
# --------------------------------------------------------------------------
def make_scan_block(n: int, block: int, dtype=torch.float32) -> KernelDef:
    if block < 1 or block & (block - 1):
        raise ValueError(f"scan_block: block must be a power of two, got "
                         f"{block}")

    def load(ctx, st):
        return st.set_shared(s=index.put(st.shared["s"], ctx.tid,
                                         index.take(st.glob["x"], _gid(ctx))))

    def make_read(d):
        def read(ctx, st):
            s = st.shared["s"]
            t = torch.where(ctx.tid >= d,
                            index.take(s, (ctx.tid - d).clamp(min=0)), 0.0)
            return st.with_priv({"t": t})
        return read

    def make_write(d):
        def write(ctx, st):
            s = st.shared["s"]
            return st.with_priv({}).set_shared(
                s=index.put(s, ctx.tid, index.take(s, ctx.tid) + st.priv["t"]))
        return write

    def store(ctx, st):
        return st.set_glob(y=index.put(st.glob["y"], _gid(ctx),
                                       index.take(st.shared["s"], ctx.tid)))

    stages = [load]
    d = 1
    while d < block:
        stages += [make_read(d), make_write(d)]
        d *= 2
    stages.append(store)
    return KernelDef(
        "scan_block", tuple(stages), writes=("y",), reads=("x", "y"),
        shared={"s": ((block,), dtype)},
        est_block_work=block * math.log2(block) * 4.0,
        native=Native.of("scan_block", n=n, nthreads=block),
    )


# --------------------------------------------------------------------------
# transpose_tiled: shared-staged transpose (coalescing demo, SVI-C)
# --------------------------------------------------------------------------
def make_transpose_tiled(h: int, w: int, tile: int = 8,
                         dtype=torch.float32) -> KernelDef:
    if h % tile or w % tile:
        raise ValueError(f"transpose_tiled: h, w = {h}, {w} must be "
                         f"multiples of the tile {tile}")
    ntx = w // tile

    def coords(ctx):
        return (ctx.tid // tile, ctx.tid % tile, ctx.bid // ntx,
                ctx.bid % ntx)

    def load(ctx, st):
        ty, tx, by, bx = coords(ctx)
        t = index.put(st.shared["t"], (ty, tx),
                      index.take(st.glob["x"], by * tile + ty,
                                 bx * tile + tx))
        return st.set_shared(t=t)

    def store(ctx, st):
        ty, tx, by, bx = coords(ctx)
        y = index.put(st.glob["y"], (bx * tile + ty, by * tile + tx),
                      index.take(st.shared["t"], tx, ty))
        return st.set_glob(y=y)

    native = Native.of("transpose_tiled", h=h, w=w) if tile == 8 else None
    return KernelDef(
        "transpose_tiled", (load, store), writes=("y",), reads=("x", "y"),
        shared={"t": ((tile, tile), dtype)},
        est_block_work=tile * tile * 4.0,
        native=native,
    )


# --------------------------------------------------------------------------
# pixel_pipeline: defensive-barrier elementwise pipeline (srad's extract /
# compress stages folded into one kernel).  Every thread touches only its
# own shared scratch cell, so both barriers are removable; a naive port
# keeps them, and so does the hand-written kernel.
# --------------------------------------------------------------------------
def make_pixel_pipeline(n: int, block: int, c0: float = 0.85,
                        c1: float = 0.1, dtype=torch.float32) -> KernelDef:
    def extract(ctx, st):
        v = index.take(st.glob["img"], _gid(ctx))
        return st.set_shared(buf=index.put(st.shared["buf"], ctx.tid,
                                           torch.log(v)))

    def adjust(ctx, st):
        b = st.shared["buf"]
        return st.set_shared(buf=index.put(b, ctx.tid,
                                           index.take(b, ctx.tid) * c0 + c1))

    def compress(ctx, st):
        out = index.put(st.glob["out"], _gid(ctx),
                        torch.exp(index.take(st.shared["buf"], ctx.tid)))
        return st.set_glob(out=out)

    return KernelDef(
        "pixel_pipeline", (extract, adjust, compress), writes=("out",),
        reads=("img", "out"),
        shared={"buf": ((block,), dtype)},
        est_block_work=block * 20.0,
        native=Native.of("pixel_pipeline", n=n, nthreads=block, c0=c0,
                         c1=c1),
    )


# --------------------------------------------------------------------------
# bfs_frontier (Rodinia bfs): level-synchronous BFS.  Each launch expands the
# current frontier; threads claim unvisited neighbors with an atomicCAS on
# the visited-flag array, winners publish dist/next-frontier, and the block
# counts its wins with __syncthreads_count into a host-readable stop flag.
# --------------------------------------------------------------------------
def make_bfs_frontier(n: int, deg: int) -> KernelDef:
    def expand(ctx, st):
        t = _gid(ctx)
        lvl = st.glob["level"][0]
        in_f = index.take(st.glob["frontier"], t) == 1
        visited = st.glob["visited"]
        nxt, dist = st.glob["nxt"], st.glob["dist"]
        edges = st.glob["edges"]
        won_any = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        for k in range(deg):
            nbr = index.take(edges, t, k)            # == n for padding slots
            attempt = in_f & (nbr < n)
            # inactive threads CAS an out-of-range slot with a compare
            # value that can never match a 0/1 flag
            idx = _where(attempt, nbr, n)
            cmp = _where(attempt, 0, -1)
            visited, old = ctx.atomic_cas(visited, idx, cmp,
                                          torch.ones_like(idx))
            won = attempt & (old == 0)
            widx = _where(won, nbr, OOB)
            nxt = index.put(nxt, widx, 1)
            dist = index.put(dist, widx, lvl + 1)
            won_any = won_any | won
        nwin = ctx.syncthreads_count(won_any)
        active = ctx.atomic_add(st.glob["active"],
                                _where(ctx.tid == 0, 0, OOB), nwin)
        return st.set_glob(visited=visited, nxt=nxt, dist=dist,
                           active=active)

    return KernelDef(
        "bfs_frontier", (expand,),
        writes=("visited", "nxt", "dist", "active"),
        reads=("edges", "frontier", "visited", "nxt", "dist", "active",
               "level"),
        uses_warp=True,
        combines={"visited": "max", "nxt": "max", "dist": "max",
                  "active": "sum"},
        donates=("visited", "nxt", "dist", "active"),
        est_block_work=deg * 64.0,
        native=Native.of("bfs_frontier", n=n, deg=deg),
    )


# --------------------------------------------------------------------------
# pathfinder (Rodinia pathfinder): row-wavefront dynamic programming.  One
# launch per wall row; each block stages the previous row into shared with a
# halo, takes the 3-neighbor min, and adds the current row's weights.  The
# host chain ping-pongs src/dst between launches.
# --------------------------------------------------------------------------
def make_pathfinder(cols: int, block: int, dtype=torch.int32) -> KernelDef:
    def load(ctx, st):
        col = _gid(ctx)
        src = st.glob["src"]
        s = index.put(st.shared["s"], ctx.tid + 1,
                      index.take(src, col.clamp(0, cols - 1)))
        left = index.take(src, (col - 1).clamp(0, cols - 1))
        right = index.take(src, (col + 1).clamp(0, cols - 1))
        s = index.put(s, _where(ctx.tid == 0, 0, OOB), left)
        s = index.put(s, _where(ctx.tid == block - 1, block + 1, OOB), right)
        return st.set_shared(s=s)

    def compute(ctx, st):
        col = _gid(ctx)
        r = st.glob["row"][0]
        s = st.shared["s"]
        best = torch.minimum(torch.minimum(index.take(s, ctx.tid),
                                           index.take(s, ctx.tid + 1)),
                             index.take(s, ctx.tid + 2))
        v = index.take(st.glob["wall"], r, col.clamp(0, cols - 1)) + best
        idx = _where(col < cols, col, OOB)
        return st.set_glob(dst=index.put(st.glob["dst"], idx, v))

    native = (Native.of("pathfinder", cols=cols)
              if block == 64 and dtype == torch.int32 else None)
    return KernelDef(
        "pathfinder", (load, compute), writes=("dst",),
        reads=("wall", "src", "dst", "row"),
        shared={"s": ((block + 2,), dtype)},
        combines={"dst": "sum"},
        donates=("dst",),
        est_block_work=block * 6.0,
        native=native,
    )


# --------------------------------------------------------------------------
# needle_nw (Rodinia nw): Needleman-Wunsch anti-diagonal wavefront.  One
# launch per anti-diagonal; each cell on the diagonal depends only on the
# two previous diagonals, already final in global memory.
# --------------------------------------------------------------------------
def make_needle_nw(n: int, penalty: int = 2) -> KernelDef:
    """dtype-agnostic stages; the native kernel takes int32 only."""
    def stage(ctx, st):
        t = _gid(ctx)
        d = st.glob["diag"][0]
        lo = (d - n).clamp(min=1)
        hi = (d - 1).clamp(max=n)
        valid = t <= hi - lo
        i = (t + lo).clamp(1, n)
        j = (d - i).clamp(1, n)
        score, sim = st.glob["score"], st.glob["sim"]
        dv = index.take(score, i - 1, j - 1) + index.take(sim, i - 1, j - 1)
        up = index.take(score, i - 1, j) - penalty
        lf = index.take(score, i, j - 1) - penalty
        v = torch.maximum(dv, torch.maximum(up, lf))
        idx = _where(valid, i, OOB)
        return st.set_glob(score=index.put(score, (idx, j), v))

    return KernelDef(
        "needle_nw", (stage,), writes=("score",),
        reads=("score", "sim", "diag"),
        combines={"score": "sum"},
        donates=("score",),
        est_block_work=64.0,
        native=Native.of("needle_nw", n=n, penalty=penalty),
    )


# --------------------------------------------------------------------------
# hotspot (Rodinia hotspot): the RC thermal update.  The temperature and
# power grids arrive through hotspot's one-value-per-line text files
# (rodinia_io); each launch stages a haloed temperature tile into shared
# memory and applies the thermal step; the chain ping-pongs t <-> t_out
# with the power grid in __constant__ space.
# --------------------------------------------------------------------------
def make_hotspot(h: int, w: int, tile_y: int = 8, tile_x: int = 8,
                 cap: float = 0.5, rx: float = 0.1, ry: float = 0.1,
                 rz: float = 0.05, amb: float = 80.0) -> KernelDef:
    def load(ctx, st):
        tx, ty, _ = ctx.tid3
        bx, by, _ = ctx.bid3
        row, col = by * tile_y + ty, bx * tile_x + tx
        t = st.glob["t"]

        def at(r, c):
            return index.take(t, r.clamp(0, h - 1), c.clamp(0, w - 1))

        s = index.put(st.shared["s"], (ty + 1, tx + 1), at(row, col))
        s = index.put(s, (_where(ty == 0, 0, OOB), tx + 1), at(row - 1, col))
        s = index.put(s, (_where(ty == tile_y - 1, tile_y + 1, OOB), tx + 1),
                      at(row + 1, col))
        s = index.put(s, (ty + 1, _where(tx == 0, 0, OOB)), at(row, col - 1))
        s = index.put(s, (ty + 1, _where(tx == tile_x - 1, tile_x + 1, OOB)),
                      at(row, col + 1))
        return st.set_shared(s=s)

    def compute(ctx, st):
        tx, ty, _ = ctx.tid3
        bx, by, _ = ctx.bid3
        row, col = by * tile_y + ty, bx * tile_x + tx
        rc, cc = row.clamp(0, h - 1), col.clamp(0, w - 1)
        s = st.shared["s"]
        tc = index.take(s, ty + 1, tx + 1)
        p = index.take(st.glob["p"], rc, cc)
        v = tc + cap * (
            p
            + ry * (index.take(s, ty, tx + 1) + index.take(s, ty + 2, tx + 1)
                    - 2.0 * tc)
            + rx * (index.take(s, ty + 1, tx) + index.take(s, ty + 1, tx + 2)
                    - 2.0 * tc)
            + rz * (amb - tc))
        idx = _where((row < h) & (col < w), row, OOB)
        return st.set_glob(t_out=index.put(st.glob["t_out"], (idx, cc), v))

    native = (Native.of("hotspot", h=h, w=w, cap=cap, rx=rx, ry=ry, rz=rz,
                        amb=amb)
              if (tile_y, tile_x) == (8, 8) else None)
    return KernelDef(
        "hotspot", (load, compute), writes=("t_out",),
        reads=("t", "p", "t_out"),
        shared={"s": ((tile_y + 2, tile_x + 2), torch.float32)},
        combines={"t_out": "sum"},
        donates=("t_out",),
        est_block_work=tile_y * tile_x * 14.0,
        native=native,
    )


# --------------------------------------------------------------------------
# backprop_layer (Rodinia backprop): forward pass of one layer (barrier-tree
# dot product + sigmoid) fused with the weight-delta update.  Each block
# owns one hidden unit; thread i owns input i.
# --------------------------------------------------------------------------
def make_backprop_layer(in_n: int, out_n: int, lr: float = 0.3) -> KernelDef:
    if in_n < 1 or in_n & (in_n - 1):
        raise ValueError(f"backprop_layer: in_n must be a power of two, "
                         f"got {in_n}")

    def load(ctx, st):
        v = (index.take(st.glob["inp"], ctx.tid)
             * index.take(st.glob["w"], ctx.bid, ctx.tid))
        return st.set_shared(s=index.put(st.shared["s"], ctx.tid, v))

    def make_level(offset):
        def level(ctx, st):
            s = st.shared["s"]
            mine = index.take(s, ctx.tid)
            new = torch.where(ctx.tid < offset,
                              mine + index.take(s, ctx.tid + offset), mine)
            return st.set_shared(s=index.put(s, ctx.tid, new))
        return level

    def store(ctx, st):
        j = ctx.bid
        total = st.shared["s"][0] + index.take(st.glob["bias"], j)
        h = 1.0 / (1.0 + torch.exp(-total))
        hidden = index.put(st.glob["hidden"], _where(ctx.tid == 0, j, OOB), h)
        wo = index.put(st.glob["w_out"], (j, ctx.tid),
                       index.take(st.glob["w"], j, ctx.tid)
                       + lr * index.take(st.glob["delta"], j)
                       * index.take(st.glob["inp"], ctx.tid))
        return st.set_glob(hidden=hidden, w_out=wo)

    stages = [load]
    off = in_n // 2
    while off >= 1:
        stages.append(make_level(off))
        off //= 2
    stages.append(store)
    return KernelDef(
        "backprop_layer", tuple(stages), writes=("hidden", "w_out"),
        reads=("inp", "w", "bias", "delta", "hidden", "w_out"),
        shared={"s": ((in_n,), torch.float32)},
        combines={"hidden": "concat", "w_out": "concat"},
        est_block_work=in_n * 10.0,
        native=Native.of("backprop_layer", in_n=in_n, out_n=out_n, lr=lr),
    )


# --------------------------------------------------------------------------
# lud_diag (Rodinia lud): the diagonal-block LU step.  Each block factors
# its own b x b tile in shared memory - b-1 barrier-separated elimination
# steps (Doolittle, no pivoting) - then writes L\U back to its owned rows.
# --------------------------------------------------------------------------
def make_lud_diag(ntiles: int, b: int) -> KernelDef:
    def load(ctx, st):
        row = ctx.bid * b + ctx.tid
        return st.set_shared(s=index.put(st.shared["s"], ctx.tid,
                                         index.take(st.glob["a"], row)))

    def make_step(k):
        def step(ctx, st):
            s = st.shared["s"]
            i = ctx.tid
            m = index.take(s, i, k) / s[k, k]
            cols = torch.arange(b, device=s.device)
            upd = torch.where(cols[None, :] > k, s[k][None, :], 0.0)
            newrow = index.take(s, i) - m[:, None] * upd
            newrow[:, k] = m                  # k < b: always in range
            return st.set_shared(s=index.put(s, _where(i > k, i, OOB),
                                             newrow))
        return step

    def store(ctx, st):
        row = ctx.bid * b + ctx.tid
        return st.set_glob(lu=index.put(st.glob["lu"], row,
                                        index.take(st.shared["s"], ctx.tid)))

    stages = [load] + [make_step(k) for k in range(b - 1)] + [store]
    return KernelDef(
        "lud_diag", tuple(stages), writes=("lu",), reads=("a", "lu"),
        shared={"s": ((b, b), torch.float32)},
        combines={"lu": "concat"},
        est_block_work=b * b * b * 2.0,
        native=Native.of("lud_diag", ntiles=ntiles, b=b),
    )


# --------------------------------------------------------------------------
# lavamd (Rodinia lavaMD): particle potential over a neighbour-box list.
# Each block owns one home box; for every neighbour box it stages that
# box's positions and charges into shared memory, barriers, and adds the
# pairwise potential into a register accumulator that lives across
# 2*nnei barriers.
# --------------------------------------------------------------------------
def make_lavamd(nboxes: int, ppb: int, nnei: int,
                alpha: float = 0.5) -> KernelDef:
    def init(ctx, st):
        return st.with_priv({"acc": torch.zeros(ctx.tid.shape,
                                                dtype=torch.float32,
                                                device=ctx.tid.device)})

    def make_load(k):
        def load(ctx, st):
            base = index.take(st.glob["nbr"], ctx.bid, k) * ppb
            sy = index.put(st.shared["sy"], ctx.tid,
                           index.take(st.glob["pos"], base + ctx.tid))
            sq = index.put(st.shared["sq"], ctx.tid,
                           index.take(st.glob["q"], base + ctx.tid))
            return st.set_shared(sy=sy, sq=sq)
        return load

    def compute(ctx, st):
        x = index.take(st.glob["pos"], ctx.bid * ppb + ctx.tid)
        sy, sq = st.shared["sy"], st.shared["sq"]
        d = x[:, None] - sy[None, :]
        u = torch.sum(sq[None, :] * torch.exp(-alpha * d * d), dim=1)
        return st.with_priv({"acc": st.priv["acc"] + u})

    def store(ctx, st):
        f = index.put(st.glob["force"], ctx.bid * ppb + ctx.tid,
                      st.priv["acc"])
        return st.with_priv({}).set_glob(force=f)

    stages = [init]
    for k in range(nnei):
        stages += [make_load(k), compute]
    stages.append(store)
    return KernelDef(
        "lavamd", tuple(stages), writes=("force",),
        reads=("pos", "q", "nbr", "force"),
        shared={"sy": ((ppb,), torch.float32),
                "sq": ((ppb,), torch.float32)},
        combines={"force": "concat"},  # block b owns rows [b*ppb, b*ppb+ppb)
        est_block_work=nnei * ppb * ppb * 6.0,
        native=Native.of("lavamd", nboxes=nboxes, ppb=ppb, nnei=nnei,
                         alpha=alpha),
    )


# --------------------------------------------------------------------------
# streamcluster (Rodinia streamcluster pgain): evaluate opening a candidate
# centre.  Every point compares its current assignment cost with the
# candidate's; switchers add their saving to the global gain and to their
# old centre's saving with atomicAdd, and claim the old centre's dirty flag
# with atomicCAS (the winner bumps the distinct-dirty counter).
# --------------------------------------------------------------------------
def make_streamcluster(n: int, k: int) -> KernelDef:
    def stage(ctx, st):
        i = _gid(ctx)
        g = i.clamp(max=n - 1)
        valid = i < n
        a = index.take(st.glob["assign"], g)
        px, py = index.take(st.glob["px"], g), index.take(st.glob["py"], g)
        cx, cy, cand = st.glob["cx"], st.glob["cy"], st.glob["cand"]
        dcur = (px - index.take(cx, a)) ** 2 + (py - index.take(cy, a)) ** 2
        dcand = (px - cand[0]) ** 2 + (py - cand[1]) ** 2
        sw = valid & (dcand < dcur)
        save = dcur - dcand
        gain = ctx.atomic_add(st.glob["gain"], _where(sw, 0, OOB), save)
        csave = ctx.atomic_add(st.glob["csave"], _where(sw, a, OOB), save)
        # inactive threads CAS a past-the-end slot with an impossible
        # compare value (the bfs_frontier idiom)
        dirty, old = ctx.atomic_cas(st.glob["dirty"], _where(sw, a, k),
                                    _where(sw, 0, -1), torch.ones_like(a))
        won = sw & (old == 0)
        ndirty = ctx.atomic_add(st.glob["ndirty"], _where(won, 0, OOB), 1)
        switched = index.put(st.glob["switched"], _where(sw, i, OOB), 1)
        return st.set_glob(gain=gain, csave=csave, dirty=dirty,
                           ndirty=ndirty, switched=switched)

    return KernelDef(
        "streamcluster", (stage,),
        writes=("gain", "csave", "dirty", "ndirty", "switched"),
        reads=("px", "py", "cx", "cy", "cand", "assign", "gain", "csave",
               "dirty", "ndirty", "switched"),
        combines={"gain": "sum", "csave": "sum", "dirty": "max",
                  "ndirty": "sum", "switched": "sum"},
        donates=("gain", "csave", "dirty", "ndirty", "switched"),
        est_block_work=64.0,
        native=Native.of("streamcluster", n=n, k=k),
    )


# --------------------------------------------------------------------------
# srad_step (Rodinia srad): speckle-reducing anisotropic diffusion.  Each
# iteration is a two-kernel chain: a barrier-tree statistics reduction into
# per-block partials, then a 2-D dim3 stencil update whose diffusion
# coefficient comes from the image-wide statistics (the update kernel folds
# the partials; Rodinia folds them on the host).
# --------------------------------------------------------------------------
def make_srad_stats(h: int, w: int, block: int) -> KernelDef:
    npix = h * w
    if block < 1 or block & (block - 1):
        raise ValueError(f"srad_stats: block must be a power of two, got "
                         f"{block}")

    def load(ctx, st):
        gid = _gid(ctx)
        g = gid.clamp(max=npix - 1)
        v = torch.where(gid < npix, index.take(st.glob["x"], g // w, g % w),
                        0.0)
        return st.set_shared(s1=index.put(st.shared["s1"], ctx.tid, v),
                             s2=index.put(st.shared["s2"], ctx.tid, v * v))

    def make_level(offset):
        def level(ctx, st):
            s1, s2 = st.shared["s1"], st.shared["s2"]
            lower = ctx.tid < offset
            m1, m2 = index.take(s1, ctx.tid), index.take(s2, ctx.tid)
            n1 = torch.where(lower, m1 + index.take(s1, ctx.tid + offset), m1)
            n2 = torch.where(lower, m2 + index.take(s2, ctx.tid + offset), m2)
            return st.set_shared(s1=index.put(s1, ctx.tid, n1),
                                 s2=index.put(s2, ctx.tid, n2))
        return level

    def store(ctx, st):
        idx = _where(ctx.tid == 0, ctx.bid, OOB)
        return st.set_glob(
            psum=index.put(st.glob["psum"], idx, st.shared["s1"][0]),
            psq=index.put(st.glob["psq"], idx, st.shared["s2"][0]))

    stages = [load]
    off = block // 2
    while off >= 1:
        stages.append(make_level(off))
        off //= 2
    stages.append(store)
    return KernelDef(
        "srad_stats", tuple(stages), writes=("psum", "psq"),
        reads=("x", "psum", "psq"),
        shared={"s1": ((block,), torch.float32),
                "s2": ((block,), torch.float32)},
        combines={"psum": "sum", "psq": "sum"},
        donates=("psum", "psq"),
        est_block_work=block * 8.0,
        native=Native.of("srad_stats", h=h, w=w, nthreads=block),
    )


def make_srad_update(h: int, w: int, lam: float = 0.2, tile_y: int = 8,
                     tile_x: int = 8) -> KernelDef:
    npix = h * w

    def stage(ctx, st):
        tx, ty, _ = ctx.tid3
        bx, by, _ = ctx.bid3
        r, c = by * tile_y + ty, bx * tile_x + tx
        x = st.glob["x"]
        total = torch.sum(st.glob["psum"])
        totsq = torch.sum(st.glob["psq"])
        mean = total / npix
        var = totsq / npix - mean * mean
        q0 = var / (mean * mean)
        rc, cc = r.clamp(0, h - 1), c.clamp(0, w - 1)

        def at(rr, cx):
            return index.take(x, rr.clamp(0, h - 1), cx.clamp(0, w - 1))

        xc = index.take(x, rc, cc)
        dn = at(rc - 1, cc) - xc
        ds = at(rc + 1, cc) - xc
        dw = at(rc, cc - 1) - xc
        de = at(rc, cc + 1) - xc
        g2 = (dn * dn + ds * ds + dw * dw + de * de) / (xc * xc)
        ll = (dn + ds + dw + de) / xc
        num = 0.5 * g2 - 0.0625 * (ll * ll)
        den = (1.0 + 0.25 * ll) * (1.0 + 0.25 * ll)
        q = num / den
        cd = 1.0 / (1.0 + (q - q0) / (q0 * (1.0 + q0)))
        cd = cd.clamp(0.0, 1.0)
        v = xc + 0.25 * lam * cd * (dn + ds + dw + de)
        idx = _where((r < h) & (c < w), rc, OOB)
        return st.set_glob(y=index.put(st.glob["y"], (idx, cc), v))

    native = (Native.of("srad_update", h=h, w=w, lam=lam)
              if (tile_y, tile_x) == (8, 8) else None)
    return KernelDef(
        "srad_update", (stage,), writes=("y",),
        reads=("x", "psum", "psq", "y"),
        combines={"y": "sum"},
        donates=("y",),
        est_block_work=tile_y * tile_x * 24.0,
        native=native,
    )


# --------------------------------------------------------------------------
# nn (Rodinia nn): k-nearest-neighbour search over hurricane records read
# through the cane text format (rodinia_io).  Each of the k output slots is
# one chain iteration: a barrier-tree arg-min into per-block partials, then
# a one-block final arg-min whose winner is appended to the output and
# masked out of the next pass through the ``taken`` flags.  The (value,
# index) pairs reduce lexicographically, so ties go to the lowest record
# index, as np.argmin's first minimum does.
# --------------------------------------------------------------------------
def _nn_argmin_level(off):
    def level(ctx, st):
        sv, si = st.shared["sv"], st.shared["si"]
        v1, i1 = index.take(sv, ctx.tid), index.take(si, ctx.tid)
        v2 = index.take(sv, ctx.tid + off)
        i2 = index.take(si, ctx.tid + off)
        take = (ctx.tid < off) & ((v2 < v1) | ((v2 == v1) & (i2 < i1)))
        return st.set_shared(
            sv=index.put(sv, ctx.tid, torch.where(take, v2, v1)),
            si=index.put(si, ctx.tid, torch.where(take, i2, i1)))
    return level


def _argmin_stages(load, store, width: int) -> tuple:
    stages = [load]
    off = width // 2
    while off >= 1:
        stages.append(_nn_argmin_level(off))
        off //= 2
    return (*stages, store)


def make_nn_reduce(n: int, block: int) -> KernelDef:
    if block < 1 or block & (block - 1):
        raise ValueError(f"nn_reduce: block must be a power of two, got "
                         f"{block}")

    def load(ctx, st):
        i = _gid(ctx)
        g = i.clamp(max=n - 1)
        tgt = st.glob["target"]
        dx = index.take(st.glob["lat"], g) - tgt[0]
        dy = index.take(st.glob["lng"], g) - tgt[1]
        d = dx * dx + dy * dy
        d = torch.where((i < n) & (index.take(st.glob["taken"], g) == 0), d,
                        torch.inf)
        return st.set_shared(sv=index.put(st.shared["sv"], ctx.tid, d),
                             si=index.put(st.shared["si"], ctx.tid, g))

    def store(ctx, st):
        idx = _where(ctx.tid == 0, ctx.bid, OOB)
        return st.set_glob(
            pval=index.put(st.glob["pval"], idx, st.shared["sv"][0]),
            pidx=index.put(st.glob["pidx"], idx, st.shared["si"][0]))

    return KernelDef(
        "nn_reduce", _argmin_stages(load, store, block),
        writes=("pval", "pidx"),
        reads=("lat", "lng", "target", "taken", "pval", "pidx"),
        shared={"sv": ((block,), torch.float32),
                "si": ((block,), torch.int32)},
        combines={"pval": "concat", "pidx": "concat"},
        donates=("pval", "pidx"),
        est_block_work=block * 8.0,
        native=Native.of("nn_reduce", n=n, nthreads=block),
    )


def make_nn_select(nblocks: int) -> KernelDef:
    if nblocks < 1 or nblocks & (nblocks - 1):
        raise ValueError(f"nn_select: nblocks must be a power of two, got "
                         f"{nblocks}")

    def load(ctx, st):
        return st.set_shared(
            sv=index.put(st.shared["sv"], ctx.tid,
                         index.take(st.glob["pval"], ctx.tid)),
            si=index.put(st.shared["si"], ctx.tid,
                         index.take(st.glob["pidx"], ctx.tid)))

    def store(ctx, st):
        step = st.glob["step"][0]
        win_v, win_i = st.shared["sv"][0], st.shared["si"][0]
        oidx = _where(ctx.tid == 0, step, OOB)
        return st.set_glob(
            out_d=index.put(st.glob["out_d"], oidx, win_v),
            out_i=index.put(st.glob["out_i"], oidx, win_i),
            taken=index.put(st.glob["taken"], _where(ctx.tid == 0, win_i, OOB),
                            1))

    return KernelDef(
        "nn_select", _argmin_stages(load, store, nblocks),
        writes=("out_d", "out_i", "taken"),
        reads=("pval", "pidx", "step", "out_d", "out_i", "taken"),
        shared={"sv": ((nblocks,), torch.float32),
                "si": ((nblocks,), torch.int32)},
        combines={"out_d": "sum", "out_i": "sum", "taken": "max"},
        est_block_work=nblocks * 6.0,
        native=Native.of("nn_select", nblocks=nblocks),
    )


# --------------------------------------------------------------------------
# kmeans (Rodinia kmeans): Lloyd iterations as a LaunchChain with a stop
# flag.  The assign kernel labels every point with its nearest centroid and
# adds per-cluster coordinate sums, counts and a moved-points counter with
# atomicAdd; the update kernel recomputes the centroids from the sums.  The
# coordinates are integer-valued floats, so every sum and the centroid
# division are exact on every backend.
# --------------------------------------------------------------------------
def make_kmeans_assign(n: int, k: int) -> KernelDef:
    def stage(ctx, st):
        i = _gid(ctx)
        g = i.clamp(max=n - 1)
        px, py = index.take(st.glob["px"], g), index.take(st.glob["py"], g)
        cx, cy = st.glob["cx"], st.glob["cy"]

        def dist(c):
            dx, dy = px - cx[c], py - cy[c]
            return dx * dx + dy * dy

        best = torch.zeros_like(g)
        bestd = dist(0)
        for c in range(1, k):
            dc = dist(c)
            closer = dc < bestd          # strict: ties keep the lower c
            best = torch.where(closer, c, best)
            bestd = torch.where(closer, dc, bestd)
        valid = i < n
        moved = valid & (index.take(st.glob["assign"], g) != best)
        changed = ctx.atomic_add(st.glob["changed"], _where(moved, 0, OOB), 1)
        assign = index.put(st.glob["assign"], _where(valid, i, OOB), best)
        bidx = _where(valid, best, OOB)
        return st.set_glob(
            changed=changed, assign=assign,
            sumx=ctx.atomic_add(st.glob["sumx"], bidx, px),
            sumy=ctx.atomic_add(st.glob["sumy"], bidx, py),
            count=ctx.atomic_add(st.glob["count"], bidx, 1))

    return KernelDef(
        "kmeans_assign", (stage,),
        writes=("assign", "changed", "sumx", "sumy", "count"),
        reads=("px", "py", "cx", "cy", "assign", "changed", "sumx", "sumy",
               "count"),
        combines={"assign": "concat", "changed": "sum", "sumx": "sum",
                  "sumy": "sum", "count": "sum"},
        donates=("changed", "sumx", "sumy", "count"),
        est_block_work=k * 64.0,
        native=Native.of("kmeans_assign", n=n, k=k),
    )


def make_kmeans_update(k: int) -> KernelDef:
    def stage(ctx, st):
        c = ctx.bid
        cnt = index.take(st.glob["count"], c)
        safe = cnt.clamp(min=1).to(torch.float32)
        empty = cnt == 0                 # an empty cluster keeps its centroid
        nx = torch.where(empty, index.take(st.glob["cx"], c),
                         index.take(st.glob["sumx"], c) / safe)
        ny = torch.where(empty, index.take(st.glob["cy"], c),
                         index.take(st.glob["sumy"], c) / safe)
        idx = _where(ctx.tid == 0, c, OOB)
        return st.set_glob(cx=index.put(st.glob["cx"], idx, nx),
                           cy=index.put(st.glob["cy"], idx, ny))

    return KernelDef(
        "kmeans_update", (stage,), writes=("cx", "cy"),
        reads=("sumx", "sumy", "count", "cx", "cy"),
        combines={"cx": "concat", "cy": "concat"},
        est_block_work=16.0,
        native=Native.of("kmeans_update", k=k),
    )


# --------------------------------------------------------------------------
# Suite registry: kernel + launch config + inputs + numpy oracle
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SuiteEntry:
    """One suite workload: kernel(s), launch geometry, inputs, and oracle.

    ``chain`` is set for wavefront workloads driven by a
    :class:`~repro_torch.core.kernel.LaunchChain` (``kernel``/``grid``/
    ``block`` then describe the first step); ``const`` names buffers bound
    in ``__constant__`` space; ``tol`` is the oracle tolerance (used as
    both ``rtol`` and ``atol``); ``rodinia`` records the benchmark
    counterpart for the coverage table.  ``dim3_free`` marks kernels that
    read only linearized ids, so any ``Dim3`` factorization of the same
    grid size is equivalent; ``nondeterministic_shard`` names scratch
    buffers whose *bit* pattern legitimately differs between a sharded
    and a single-device run (a win counter deduplicated per device) -
    excluded from cross-backend bit comparisons, never from semantic
    checks; ``iteration_state`` names per-iteration chain scratch (stop
    counters, frontier ping-pongs) whose final bits depend on the
    stop-poll cadence - a device-resident replay may overshoot a
    converged stop flag by up to ``check_every - 1`` no-op iterations, so
    these are excluded from host-hop-vs-device-resident bit comparisons
    (the oracle outputs never are).  The three are the reference's
    declarations; conformance, shard and device-resident chains read
    them.
    """

    name: str
    features: tuple[str, ...]
    kernel: KernelDef
    grid: int | tuple
    block: int | tuple
    dyn_shared: int | None
    make_args: Callable[[np.random.Generator], dict]
    reference: Callable[[dict], dict]
    chain: LaunchChain | None = None
    const: tuple[str, ...] = ()
    tol: float = 2e-5
    rodinia: str = ""
    dim3_free: bool = True
    nondeterministic_shard: tuple[str, ...] = ()
    iteration_state: tuple[str, ...] = ()


def entry_steps(entry: SuiteEntry) -> tuple[ChainStep, ...]:
    """The launches of one iteration: a chain's steps in order (two
    different kernels for srad_step, nn and kmeans), or a plain entry's
    one launch."""
    if entry.chain is None:
        return (ChainStep(entry.kernel, entry.grid, entry.block,
                          entry.dyn_shared),)
    return tuple(entry.chain.steps)


def run_entry(entry: SuiteEntry, backend: str = "loop", *, rng=None,
              args: dict | None = None, grain=1, pool=None, grid=None,
              block=None, with_reference: bool = True,
              chain_mode: str = "host",
              chain_stats: ChainStats | None = None,
              check_every: int | None = None, device=None,
              optimize: bool | None = None, devices: int | None = None):
    """Execute a suite entry end to end under one backend.

    A plain entry is one launch, at ``grid``/``block`` when given and at
    the entry's geometry otherwise; a chain entry replays its
    :class:`LaunchChain` with every step routed through the same options
    (its geometry is per step, so overrides raise ``ValueError``).
    Inputs come from ``entry.make_args`` (seeded ``rng``, default
    ``default_rng(42)``) or ``args``, and go to ``device`` through
    :func:`repro_torch.carry.from_reference` - the card unless the caller
    asks for ``"cpu"``.  Returns ``(out, want)``: the final buffer dict
    (tensors) and the NumPy oracle's expectation (``None`` when
    ``with_reference=False``).

    ``chain_mode`` selects a chain's replay: ``"host"`` is the
    per-iteration host-hop baseline, ``"device"`` the device-resident
    replay (on-device update hooks, stop flag read back every
    ``check_every`` iterations, the chain's own period by default), and
    ``"graph"`` the graph-captured replay over a
    :class:`~repro_torch.core.streams.Stream` (on the card a
    ``torch.cuda.CUDAGraph``).  A plain entry takes only ``"host"``.
    ``chain_stats`` collects a chain's replay counters.  ``optimize``
    reaches every launch (a plain entry's, each chain step's, in every
    ``chain_mode``): ``True`` runs the barrier-fission optimizer's derived
    kernels.  ``devices`` caps a multi-device backend's shard count in
    every launch (single-device backends ignore it).
    """
    if entry.chain is None:
        if chain_mode != "host":
            raise ValueError(
                f"entry {entry.name}: chain_mode={chain_mode!r} needs a "
                f"LaunchChain entry (this one is a single launch)")
    elif grid is not None or block is not None:
        raise ValueError(
            f"entry {entry.name}: geometry overrides are per-step for "
            f"chain entries; rebuild the chain instead")
    elif chain_mode not in ("host", "device", "graph"):
        raise ValueError(f"unknown chain_mode {chain_mode!r}; expected "
                         f"host | device | graph")
    if args is None:
        args = entry.make_args(rng if rng is not None
                               else np.random.default_rng(42))
    want = entry.reference(args) if with_reference else None
    bufs = carry.from_reference(args, const=entry.const, device=device)
    kw = dict(backend=backend, grain=grain, pool=pool, optimize=optimize,
              devices=devices)
    if entry.chain is None:
        return launch(entry.kernel,
                      grid=entry.grid if grid is None else grid,
                      block=entry.block if block is None else block,
                      args=bufs, dyn_shared=entry.dyn_shared, **kw), want

    def launch_step(step, b):
        return launch(step.kernel, grid=step.grid, block=step.block,
                      args=b, dyn_shared=step.dyn_shared, **kw)

    if chain_mode == "host":
        out = entry.chain.run(launch_step, bufs, stats=chain_stats)
    elif chain_mode == "device":
        out = entry.chain.run_device(launch_step, bufs,
                                     check_every=check_every,
                                     stats=chain_stats)
    else:
        out = entry.chain.run_graph(Stream(bufs), check_every=check_every,
                                    stats=chain_stats, **kw)
    return out, want


def _device_of(bufs: dict) -> torch.device:
    return next(v for v in bufs.values()
                if isinstance(v, torch.Tensor)).device


def _scalar(v: int, bufs: dict) -> torch.Tensor:
    return torch.full((1,), v, dtype=torch.int32, device=_device_of(bufs))


# --------------------------------------------------------------------------
# Entry builders (defaults = the reference package's test sizes)
# --------------------------------------------------------------------------
def bfs_levels(edges: np.ndarray, n: int) -> np.ndarray:
    """BFS distances from node 0 (-1 = unreachable), one level at a time."""
    dist = np.full(n, -1, np.int32)
    dist[0] = 0
    frontier = np.array([0])
    level = 0
    while frontier.size:
        nbrs = edges[frontier].reshape(-1)
        nbrs = np.unique(nbrs[nbrs < n])
        nbrs = nbrs[dist[nbrs] < 0]
        level += 1
        dist[nbrs] = level
        frontier = nbrs
    return dist


def entry_bfs_frontier(n: int = 64, deg: int = 4) -> SuiteEntry:
    kernel = make_bfs_frontier(n, deg)
    block, grid = 32, n // 32     # 32-thread blocks: __syncthreads_count

    def margs(r):
        edges = np.full((n, deg), n, np.int32)
        edges[:, 0] = (np.arange(n) + 1) % n      # ring: everything reachable
        for k in range(1, deg):
            edges[:, k] = r.integers(0, n, n)     # random chords
        frontier = np.zeros(n, np.int32)
        frontier[0] = 1
        visited = np.zeros(n, np.int32)
        visited[0] = 1
        dist = np.full(n, -1, np.int32)
        dist[0] = 0
        return {"edges": edges, "frontier": frontier, "visited": visited,
                "dist": dist, "nxt": np.zeros(n, np.int32),
                "active": np.zeros(1, np.int32),
                "level": np.zeros(1, np.int32)}

    def ref(a):
        dist = bfs_levels(np.asarray(a["edges"]), n)
        return {"dist": dist, "visited": (dist >= 0).astype(np.int32)}

    def prepare(it, bufs):
        if it == 0:
            return {}
        return {"frontier": bufs["nxt"],
                "nxt": torch.zeros_like(bufs["nxt"]),
                "active": torch.zeros_like(bufs["active"]),
                "level": _scalar(it, bufs)}

    def update(bufs):
        # device-resident prepare: the level counter lives on the device
        # and increments there - no per-iteration host scalar
        return {"frontier": bufs["nxt"],
                "nxt": torch.zeros_like(bufs["nxt"]),
                "active": torch.zeros_like(bufs["active"]),
                "level": bufs["level"] + 1}

    chain = LaunchChain(
        steps=(ChainStep(kernel, grid, block, prepare=prepare,
                         update=update),),
        repeat=n,                 # upper bound; stop flag exits early
        stop=lambda bufs: int(bufs["active"][0]) == 0,
        device_stop=lambda bufs: bufs["active"][0] == 0,
        check_every=4,            # device-resident stop-poll period
    )
    return SuiteEntry(
        "bfs_frontier", ("atomic_cas", "warp", "const", "chain"),
        kernel, grid, block, None, margs, ref,
        chain=chain, const=("edges",), rodinia="bfs", dim3_free=False,
        # the win counter dedups per device: shards that independently
        # claim the same node both count it
        nondeterministic_shard=("active",),
        # overshooting a converged frontier is a no-op for dist/visited,
        # but leaves the ping-pong scratch at a cadence-dependent state
        iteration_state=("frontier", "nxt", "active", "level"))


def entry_pathfinder(scale: int = 1, dtype=torch.int32, *, rows: int = 6,
                     cols: int | None = None) -> SuiteEntry:
    cols = 256 * scale if cols is None else cols
    block = 64
    kernel = make_pathfinder(cols, block, dtype=dtype)
    grid = -(-cols // block)      # ceil: every column gets a thread
    npdt = np.dtype(str(dtype).removeprefix("torch."))

    def margs(r):
        # integer-valued weights stay exact under every dtype variant
        wall = r.integers(0, 10, (rows, cols)).astype(npdt)
        return {"wall": wall, "src": wall[0].copy(),
                "dst": np.zeros(cols, npdt),
                "row": np.ones(1, np.int32)}

    def ref(a):
        wall = np.asarray(a["wall"])
        cur = np.asarray(a["src"]).copy()
        idx = np.arange(cols)
        for r in range(1, rows):
            left = cur[np.clip(idx - 1, 0, cols - 1)]
            right = cur[np.clip(idx + 1, 0, cols - 1)]
            cur = wall[r] + np.minimum(np.minimum(left, cur), right)
        return {"dst": cur}

    def prepare(it, bufs):
        upd = {"row": _scalar(it + 1, bufs),
               "dst": torch.zeros_like(bufs["dst"])}
        if it:
            upd["src"] = bufs["dst"]
        return upd

    def update(bufs):
        # device-resident ping-pong: src takes the previous dst, the row
        # counter increments on the device
        return {"src": bufs["dst"], "dst": torch.zeros_like(bufs["dst"]),
                "row": bufs["row"] + 1}

    chain = LaunchChain(
        steps=(ChainStep(kernel, grid, block, prepare=prepare,
                         update=update),),
        repeat=rows - 1,
    )
    return SuiteEntry(
        "pathfinder", ("barrier", "chain"), kernel, grid, block, None,
        margs, ref, chain=chain, rodinia="pathfinder", dim3_free=False)


def nw_scores(score: np.ndarray, sim: np.ndarray, penalty: int) -> np.ndarray:
    """The Needleman-Wunsch matrix, one anti-diagonal at a time."""
    s = np.asarray(score).copy()
    n = s.shape[0] - 1
    for d in range(2, 2 * n + 1):
        i = np.arange(max(1, d - n), min(n, d - 1) + 1)
        j = d - i
        s[i, j] = np.maximum(s[i - 1, j - 1] + sim[i - 1, j - 1],
                             np.maximum(s[i - 1, j] - penalty,
                                        s[i, j - 1] - penalty))
    return s


def entry_needle_nw(n: int = 32, penalty: int = 2,
                    dtype=torch.int32) -> SuiteEntry:
    block = 16
    grid = n // block
    kernel = make_needle_nw(n, penalty)
    npdt = np.dtype(str(dtype).removeprefix("torch."))

    def margs(r):
        # integer-valued similarity scores stay exact under f32 too
        sim = r.integers(-3, 4, (n, n)).astype(npdt)
        score = np.zeros((n + 1, n + 1), npdt)
        score[0, :] = -penalty * np.arange(n + 1)
        score[:, 0] = -penalty * np.arange(n + 1)
        return {"score": score, "sim": sim, "diag": np.full(1, 2, np.int32)}

    def ref(a):
        return {"score": nw_scores(a["score"], np.asarray(a["sim"]),
                                   penalty)}

    chain = LaunchChain(
        steps=(ChainStep(
            kernel, grid, block,
            prepare=lambda it, bufs: {"diag": _scalar(it + 2, bufs)},
            update=lambda bufs: {"diag": bufs["diag"] + 1}),),
        repeat=2 * n - 1,
    )
    return SuiteEntry(
        "needle_nw", ("chain",), kernel, grid, block, None, margs, ref,
        chain=chain, rodinia="nw", dim3_free=False)


def entry_hotspot(h: int = 32, w: int = 64, iters: int = 4,
                  cap: float = 0.5, rx: float = 0.1, ry: float = 0.1,
                  rz: float = 0.05, amb: float = 80.0) -> SuiteEntry:
    kernel = make_hotspot(h, w, cap=cap, rx=rx, ry=ry, rz=rz, amb=amb)

    def margs(r):
        temp = r.uniform(60.0, 100.0, (h, w)).astype(np.float32)
        power = r.uniform(0.0, 1.0, (h, w)).astype(np.float32)
        # round-trip through hotspot's temp_*/power_* file format: the
        # parsed grids are what the kernels AND the oracle both consume
        temp = rodinia_io.parse_grid(rodinia_io.format_grid(temp), h, w)
        power = rodinia_io.parse_grid(rodinia_io.format_grid(power), h, w)
        return {"t": temp, "p": power,
                "t_out": np.zeros((h, w), np.float32)}

    def ref(a):
        t = np.asarray(a["t"], np.float32).copy()
        p = np.asarray(a["p"], np.float32)
        for _ in range(iters):
            tp = np.pad(t, 1, mode="edge")
            north, south = tp[:-2, 1:-1], tp[2:, 1:-1]
            west, east = tp[1:-1, :-2], tp[1:-1, 2:]
            t = (t + cap * (p + ry * (north + south - 2.0 * t)
                            + rx * (west + east - 2.0 * t)
                            + rz * (amb - t))).astype(np.float32)
        return {"t_out": t}

    def prep(it, bufs):
        if it == 0:
            return {}
        return upd(bufs)

    def upd(bufs):
        # device-resident t <-> t_out ping-pong
        return {"t": bufs["t_out"], "t_out": torch.zeros_like(bufs["t_out"])}

    chain = LaunchChain(
        steps=(ChainStep(kernel, (w // 8, h // 8), (8, 8), prepare=prep,
                         update=upd),),
        repeat=iters,
    )
    return SuiteEntry(
        "hotspot", ("barrier", "dim3", "chain", "const"), kernel,
        (w // 8, h // 8), (8, 8), None, margs, ref, chain=chain,
        const=("p",), tol=1e-4, rodinia="hotspot", dim3_free=False)


def entry_srad_step(scale: int = 1, iters: int = 2, lam: float = 0.2, *,
                    h: int = 32, w: int | None = None) -> SuiteEntry:
    w = 64 * scale if w is None else w
    block = 128
    npix = h * w
    grid1 = npix // block
    stats_k = make_srad_stats(h, w, block)
    update_k = make_srad_update(h, w, lam)

    def margs(r):
        return {"x": np.exp(0.1 * r.standard_normal((h, w))
                            ).astype(np.float32),
                "y": np.zeros((h, w), np.float32),
                "psum": np.zeros(grid1, np.float32),
                "psq": np.zeros(grid1, np.float32)}

    def ref(a):
        x = np.asarray(a["x"]).astype(np.float32).copy()
        for _ in range(iters):
            total = x.sum(dtype=np.float32)
            totsq = (x * x).sum(dtype=np.float32)
            mean = total / npix
            var = totsq / npix - mean * mean
            q0 = var / (mean * mean)
            xp = np.pad(x, 1, mode="edge")
            dn = xp[:-2, 1:-1] - x
            ds = xp[2:, 1:-1] - x
            dw = xp[1:-1, :-2] - x
            de = xp[1:-1, 2:] - x
            g2 = (dn * dn + ds * ds + dw * dw + de * de) / (x * x)
            ll = (dn + ds + dw + de) / x
            num = 0.5 * g2 - 0.0625 * (ll * ll)
            den = (1.0 + 0.25 * ll) * (1.0 + 0.25 * ll)
            q = num / den
            cd = np.clip(1.0 / (1.0 + (q - q0) / (q0 * (1.0 + q0))), 0, 1)
            x = (x + 0.25 * lam * cd * (dn + ds + dw + de)
                 ).astype(np.float32)
        return {"y": x}

    def prep_stats(it, bufs):
        if it == 0:
            return {}
        return upd_stats(bufs)

    def upd_stats(bufs):
        # x <-> y ping-pong, partials re-zeroed, on the device
        return {"x": bufs["y"], "y": torch.zeros_like(bufs["y"]),
                "psum": torch.zeros_like(bufs["psum"]),
                "psq": torch.zeros_like(bufs["psq"])}

    chain = LaunchChain(
        steps=(ChainStep(stats_k, grid1, block, prepare=prep_stats,
                         update=upd_stats),
               ChainStep(update_k, (w // 8, h // 8), (8, 8))),
        repeat=iters,
    )
    return SuiteEntry(
        "srad_step", ("barrier", "dim3", "chain"), stats_k, grid1, block,
        None, margs, ref, chain=chain, tol=1e-4, rodinia="srad",
        dim3_free=False)


def entry_nn(n: int = 256, block: int = 64, knn: int = 8) -> SuiteEntry:
    grid = n // block
    reduce_k = make_nn_reduce(n, block)
    select_k = make_nn_select(grid)

    def margs(r):
        lat = r.uniform(0.0, 90.0, n).astype(np.float32)
        lng = r.uniform(0.0, 180.0, n).astype(np.float32)
        # round-trip through the cane record-file format: the parsed
        # arrays are what the kernels and the oracle both consume
        lat, lng = rodinia_io.parse_records(
            rodinia_io.format_records(lat, lng))
        return {"lat": lat, "lng": lng,
                "target": np.asarray([30.0, 90.0], np.float32),
                "taken": np.zeros(n, np.int32),
                "pval": np.zeros(grid, np.float32),
                "pidx": np.zeros(grid, np.int32),
                "out_d": np.zeros(knn, np.float32),
                "out_i": np.zeros(knn, np.int32),
                "step": np.zeros(1, np.int32)}

    def ref(a):
        lat = np.asarray(a["lat"], np.float32)
        lng = np.asarray(a["lng"], np.float32)
        tgt = np.asarray(a["target"], np.float32)
        work = (lat - tgt[0]) ** 2 + (lng - tgt[1]) ** 2
        taken = np.zeros(n, np.int32)
        out_d = np.zeros(knn, np.float32)
        out_i = np.zeros(knn, np.int32)
        for t in range(knn):
            w = int(np.argmin(work))     # first minimum: lowest index
            out_d[t] = work[w]
            out_i[t] = w
            taken[w] = 1
            work[w] = np.inf
        return {"out_d": out_d, "out_i": out_i, "taken": taken}

    chain = LaunchChain(
        steps=(ChainStep(reduce_k, grid, block),
               ChainStep(select_k, 1, grid,
                         prepare=lambda it, bufs: {
                             "step": _scalar(it, bufs)},
                         update=lambda bufs: {"step": bufs["step"] + 1})),
        repeat=knn,
    )
    return SuiteEntry(
        "nn", ("barrier", "chain", "const"), reduce_k, grid, block, None,
        margs, ref, chain=chain, const=("lat", "lng", "target"),
        rodinia="nn", dim3_free=False)


def entry_kmeans(n: int = 256, k: int = 4, block: int = 64,
                 repeat: int = 12) -> SuiteEntry:
    grid = n // block
    assign_k = make_kmeans_assign(n, k)
    update_k = make_kmeans_update(k)

    def margs(r):
        centers = np.asarray([[10, 10], [40, 12], [12, 44], [44, 40]],
                             np.float32)[:k]
        which = r.integers(0, k, n)
        px = (centers[which, 0] + r.integers(-4, 5, n)).astype(np.float32)
        py = (centers[which, 1] + r.integers(-4, 5, n)).astype(np.float32)
        return {"px": px, "py": py,
                "cx": px[:k].copy(), "cy": py[:k].copy(),
                "assign": np.zeros(n, np.int32),
                "changed": np.zeros(1, np.int32),
                "sumx": np.zeros(k, np.float32),
                "sumy": np.zeros(k, np.float32),
                "count": np.zeros(k, np.int32)}

    def ref(a):
        px = np.asarray(a["px"], np.float32)
        py = np.asarray(a["py"], np.float32)
        cx = np.asarray(a["cx"], np.float32).copy()
        cy = np.asarray(a["cy"], np.float32).copy()
        assign = np.asarray(a["assign"]).copy()
        sx = np.zeros(k, np.float32)
        sy = np.zeros(k, np.float32)
        cnt = np.zeros(k, np.int32)
        moved = 0
        for _ in range(repeat):
            d = ((px[:, None] - cx[None, :]) ** 2
                 + (py[:, None] - cy[None, :]) ** 2)
            best = np.argmin(d, axis=1).astype(np.int32)
            moved = int((best != assign).sum())
            assign = best
            cnt = np.bincount(best, minlength=k).astype(np.int32)
            sx = np.bincount(best, weights=px,
                             minlength=k).astype(np.float32)
            sy = np.bincount(best, weights=py,
                             minlength=k).astype(np.float32)
            safe = np.maximum(cnt, 1).astype(np.float32)
            cx = np.where(cnt == 0, cx, sx / safe).astype(np.float32)
            cy = np.where(cnt == 0, cy, sy / safe).astype(np.float32)
            if moved == 0:
                break
        return {"assign": assign, "cx": cx, "cy": cy, "count": cnt,
                "sumx": sx, "sumy": sy,
                "changed": np.asarray([moved], np.int32)}

    def prep_assign(it, bufs):
        if it == 0:
            return {}
        return upd_assign(bufs)

    def upd_assign(bufs):
        # the per-iteration accumulators, re-zeroed on the device
        return {name: torch.zeros_like(bufs[name])
                for name in ("changed", "sumx", "sumy", "count")}

    chain = LaunchChain(
        steps=(ChainStep(assign_k, grid, block, prepare=prep_assign,
                         update=upd_assign),
               ChainStep(update_k, k, 8)),
        repeat=repeat,                # upper bound; the stop flag ends it
        # read back to the host once per iteration in host mode, once
        # every check_every iterations in the device-resident modes
        stop=lambda bufs: int(bufs["changed"][0]) == 0,
        device_stop=lambda bufs: bufs["changed"][0] == 0,
        check_every=3,
    )
    return SuiteEntry(
        "kmeans", ("atomic", "chain"), assign_k, grid, block, None,
        margs, ref, chain=chain, const=("px", "py"), rodinia="kmeans",
        dim3_free=False)


def entry_backprop_layer(in_n: int = 64, out_n: int = 16,
                         lr: float = 0.3) -> SuiteEntry:
    kernel = make_backprop_layer(in_n, out_n, lr)

    def margs(r):
        return {"inp": r.standard_normal(in_n, dtype=np.float32),
                "w": r.standard_normal((out_n, in_n),
                                       dtype=np.float32) * 0.5,
                "bias": r.standard_normal(out_n, dtype=np.float32),
                "delta": r.standard_normal(out_n, dtype=np.float32),
                "hidden": np.zeros(out_n, np.float32),
                "w_out": np.zeros((out_n, in_n), np.float32)}

    def ref(a):
        w, inp = np.asarray(a["w"]), np.asarray(a["inp"])
        hidden = 1.0 / (1.0 + np.exp(-(w @ inp + a["bias"])))
        w_out = w + lr * np.asarray(a["delta"])[:, None] * inp[None, :]
        return {"hidden": hidden.astype(np.float32),
                "w_out": w_out.astype(np.float32)}

    return SuiteEntry(
        "backprop_layer", ("barrier", "const"), kernel, out_n, in_n, None,
        margs, ref, const=("inp", "w", "bias", "delta"),
        rodinia="backprop")


def entry_lud_diag(ntiles: int = 8, b: int = 16) -> SuiteEntry:
    kernel = make_lud_diag(ntiles, b)

    def margs(r):
        a = 0.1 * r.standard_normal((ntiles * b, b)).astype(np.float32)
        for t in range(ntiles):                 # diagonally dominant tiles
            a[t * b:(t + 1) * b] += 4.0 * np.eye(b, dtype=np.float32)
        return {"a": a, "lu": np.zeros((ntiles * b, b), np.float32)}

    def ref(a):
        src = np.asarray(a["a"])
        lu = np.zeros_like(src)
        for t in range(ntiles):
            m = src[t * b:(t + 1) * b].copy()
            for k in range(b - 1):
                m[k + 1:, k] = m[k + 1:, k] / m[k, k]
                m[k + 1:, k + 1:] -= np.outer(m[k + 1:, k], m[k, k + 1:])
            lu[t * b:(t + 1) * b] = m
        return {"lu": lu}

    return SuiteEntry(
        "lud_diag", ("barrier",), kernel, ntiles, b, None, margs, ref,
        tol=1e-4, rodinia="lud")


def entry_lavamd(nboxes: int = 8, ppb: int = 32, nnei: int = 3,
                 alpha: float = 0.5) -> SuiteEntry:
    kernel = make_lavamd(nboxes, ppb, nnei, alpha)
    n = nboxes * ppb

    def margs(r):
        nbr = np.empty((nboxes, nnei), np.int32)
        nbr[:, 0] = np.arange(nboxes)                    # home box first
        nbr[:, 1] = (np.arange(nboxes) + 1) % nboxes     # ring neighbours
        for k in range(2, nnei):
            nbr[:, k] = r.integers(0, nboxes, nboxes)
        return {"pos": r.uniform(-2.0, 2.0, n).astype(np.float32),
                "q": r.uniform(0.1, 1.0, n).astype(np.float32),
                "nbr": nbr,
                "force": np.zeros(n, np.float32)}

    def ref(a):
        pos = np.asarray(a["pos"], np.float32)
        q = np.asarray(a["q"], np.float32)
        nbr = np.asarray(a["nbr"])
        force = np.zeros(n, np.float32)
        for b in range(nboxes):
            xi = pos[b * ppb:(b + 1) * ppb]
            acc = np.zeros(ppb, np.float32)
            for k in range(nnei):
                nb = int(nbr[b, k])
                y = pos[nb * ppb:(nb + 1) * ppb]
                qq = q[nb * ppb:(nb + 1) * ppb]
                d = xi[:, None] - y[None, :]
                acc = acc + np.sum(qq[None, :] * np.exp(-alpha * d * d),
                                   axis=1, dtype=np.float32)
            force[b * ppb:(b + 1) * ppb] = acc
        return {"force": force}

    return SuiteEntry(
        "lavamd", ("barrier", "demotion", "const"), kernel, nboxes, ppb,
        None, margs, ref, const=("pos", "q", "nbr"), tol=1e-4,
        rodinia="lavaMD")


def entry_streamcluster(n: int = 256, k: int = 8,
                        block: int = 64) -> SuiteEntry:
    grid = n // block
    kernel = make_streamcluster(n, k)

    def margs(r):
        return {"px": r.integers(0, 100, n).astype(np.int32),
                "py": r.integers(0, 100, n).astype(np.int32),
                "cx": r.integers(0, 100, k).astype(np.int32),
                "cy": r.integers(0, 100, k).astype(np.int32),
                "cand": r.integers(0, 100, 2).astype(np.int32),
                "assign": r.integers(0, k, n).astype(np.int32),
                "gain": np.zeros(1, np.int32),
                "csave": np.zeros(k, np.int32),
                "dirty": np.zeros(k, np.int32),
                "ndirty": np.zeros(1, np.int32),
                "switched": np.zeros(n, np.int32)}

    def ref(a):
        px = np.asarray(a["px"], np.int64)
        py = np.asarray(a["py"], np.int64)
        cx, cy = np.asarray(a["cx"]), np.asarray(a["cy"])
        assign = np.asarray(a["assign"])
        cand = np.asarray(a["cand"])
        dcur = (px - cx[assign]) ** 2 + (py - cy[assign]) ** 2
        dcand = (px - cand[0]) ** 2 + (py - cand[1]) ** 2
        sw = dcand < dcur
        save = dcur - dcand
        gain = np.asarray([save[sw].sum()], np.int32)
        csave = np.bincount(assign[sw], weights=save[sw].astype(np.float64),
                            minlength=k).astype(np.int32)
        dirty = np.zeros(k, np.int32)
        dirty[np.unique(assign[sw])] = 1
        return {"gain": gain, "csave": csave, "dirty": dirty,
                "switched": sw.astype(np.int32)}

    return SuiteEntry(
        "streamcluster", ("atomic", "atomic_cas"), kernel, grid, block,
        None, margs, ref,
        const=("px", "py", "cx", "cy", "cand", "assign"),
        rodinia="streamcluster",
        # the CAS winner's distinct-dirty counter dedups per device
        nondeterministic_shard=("ndirty",))


# --------------------------------------------------------------------------
# The reference's textbook entries (build_suite(1)'s sizes as defaults)
# --------------------------------------------------------------------------
def entry_vecadd(n: int = 4096, block: int = 128) -> SuiteEntry:
    def margs(r):
        return {"a": r.standard_normal(n, dtype=np.float32),
                "b": r.standard_normal(n, dtype=np.float32),
                "c": np.zeros(n, np.float32)}

    return SuiteEntry(
        "vecadd", ("spmd",), make_vecadd(n), -(-n // block), block, None,
        margs, lambda a: {"c": a["a"] + a["b"]}, rodinia="(Listing 1)")


def entry_reverse(n: int = 512) -> SuiteEntry:
    """One block of ``n`` threads over ``d[n]``, with ``n`` int32 elements
    of extern shared memory."""
    return SuiteEntry(
        "reverse", ("barrier", "dyn_shared"), make_reverse(n), 1, n, n,
        lambda r: {"d": r.integers(0, 100, n).astype(np.int32)},
        lambda a: {"d": a["d"][::-1].copy()}, rodinia="(Listing 3)")


def entry_histogram(n: int = 4096, nbins: int = 64, grid: int = 16,
                    block: int = 128,
                    layout: str = "coalesced") -> SuiteEntry:
    kernel = make_histogram(n, nbins, grid * block, layout)

    def margs(r):
        return {"x": r.integers(0, nbins, n).astype(np.int32),
                "hist": np.zeros(nbins, np.int32)}

    def ref(a):
        return {"hist": np.bincount(a["x"], minlength=nbins)
                .astype(np.int32)}

    return SuiteEntry(
        "histogram", ("atomic",), kernel, grid, block, None, margs, ref,
        rodinia="Hetero-Mark HIST")


def _reduce_entry(name: str, features: tuple, make, n: int, block: int,
                  rodinia: str) -> SuiteEntry:
    grid = -(-n // block)

    def margs(r):
        return {"x": r.standard_normal(n, dtype=np.float32),
                "out": np.zeros(grid, np.float32)}

    return SuiteEntry(
        name, features, make(n, block), grid, block, None, margs,
        lambda a: {"out": a["x"].reshape(-1, block).sum(1)},
        rodinia=rodinia)


def entry_reduce_shared(n: int = 2048, block: int = 256) -> SuiteEntry:
    return _reduce_entry("reduce_shared", ("barrier",), make_reduce_shared,
                         n, block, "srad/kmeans reductions")


def entry_reduce_warp(n: int = 2048, block: int = 256) -> SuiteEntry:
    return _reduce_entry("reduce_warp", ("warp",), make_reduce_warp, n,
                         block, "Crystal q11-q13")


def matmul_tol(k: int) -> float:
    """matmul_tiled's oracle tolerance for depth ``k``: the reference's
    2e-5 at k = 32, grown as ``(k / 32) ** 0.75`` (4.5e-4 at k = 2048).

    ``tools/matmul_tol.py`` measures the plain version's worst error in
    ``allclose``'s measure, ``|c - want| / (1 + |want|)``, at m = n =
    2048 on the CPU: against NumPy's float32 product it grows 23-fold
    from k = 32 to k = 2048 (3.3e-6 to 7.4e-5, about ``k ** 0.75``), so
    the tolerance keeps the margin (6x) that 2e-5 has at k = 32."""
    return 2e-5 * (k / 32) ** 0.75


def entry_matmul_tiled(m: int = 32, n: int | None = None,
                       k: int | None = None) -> SuiteEntry:
    """``c[m, n] = a[m, k] @ b[k, n]`` in 8 x 8 tiles, one 64-thread
    block per tile (square by default, as the reference's)."""
    n = m if n is None else n
    k = m if k is None else k

    def margs(r):
        return {"a": r.standard_normal((m, k), dtype=np.float32),
                "b": r.standard_normal((k, n), dtype=np.float32),
                "c": np.zeros((m, n), np.float32)}

    return SuiteEntry(
        "matmul_tiled", ("barrier", "demotion"),
        make_matmul_tiled(m, n, k, tile=8), (m // 8) * (n // 8), 64, None,
        margs, lambda a: {"c": a["a"] @ a["b"]}, tol=matmul_tol(k),
        rodinia="lud/gemm")


def entry_stencil1d(n: int = 4096, block: int = 128) -> SuiteEntry:
    def ref(a):
        i = np.arange(n)
        return {"y": (0.25 * a["x"][np.clip(i - 1, 0, None)] + 0.5 * a["x"]
                      + 0.25 * a["x"][np.clip(i + 1, None, n - 1)])}

    return SuiteEntry(
        "stencil1d", ("barrier",), make_stencil1d(n, block), -(-n // block),
        block, None,
        lambda r: {"x": r.standard_normal(n, dtype=np.float32),
                   "y": np.zeros(n, np.float32)},
        ref, rodinia="hotspot (1-D)")


def entry_stencil2d(h: int = 32, w: int = 64) -> SuiteEntry:
    """``y = 0.2 (c + n + s + w + e)`` over ``x[h, w]``, edges clamped, on
    a 2-D grid of 8 x 8 blocks."""
    def ref(a):
        p = np.pad(a["x"], 1, mode="edge")
        return {"y": 0.2 * (p[1:-1, 1:-1] + p[:-2, 1:-1] + p[2:, 1:-1]
                            + p[1:-1, :-2] + p[1:-1, 2:])}

    return SuiteEntry(
        "stencil2d", ("barrier", "dim3"), make_stencil2d(h, w),
        (w // 8, h // 8), (8, 8), None,
        lambda r: {"x": r.standard_normal((h, w), dtype=np.float32),
                   "y": np.zeros((h, w), np.float32)},
        ref, rodinia="hotspot", dim3_free=False)


def entry_softmax_row(rows: int = 32, block: int = 128) -> SuiteEntry:
    def ref(a):
        e = np.exp(a["x"] - a["x"].max(1, keepdims=True))
        return {"y": e / e.sum(1, keepdims=True)}

    return SuiteEntry(
        "softmax_row", ("barrier",), make_softmax_row(rows, block), rows,
        block, None,
        lambda r: {"x": r.standard_normal((rows, block), dtype=np.float32),
                   "y": np.zeros((rows, block), np.float32)},
        ref, rodinia="attention primitive")


def entry_scan_block(n: int = 1024, block: int = 128) -> SuiteEntry:
    """An inclusive prefix sum within each ``block`` of ``x[n]``."""
    if n % block:
        raise ValueError(f"scan_block: n = {n} is not a multiple of the "
                         f"block {block}")
    return SuiteEntry(
        "scan_block", ("barrier", "demotion"), make_scan_block(n, block),
        n // block, block, None,
        lambda r: {"x": r.standard_normal(n, dtype=np.float32),
                   "y": np.zeros(n, np.float32)},
        lambda a: {"y": np.cumsum(a["x"].reshape(-1, block), 1)
                   .reshape(-1)},
        rodinia="pathfinder/scan")


def entry_transpose_tiled(h: int = 64, w: int = 64) -> SuiteEntry:
    """``y[w, h] = x[h, w]`` through 8 x 8 shared tiles, one 64-thread block
    per tile on a 1-D grid."""
    return SuiteEntry(
        "transpose_tiled", ("barrier",), make_transpose_tiled(h, w),
        (h // 8) * (w // 8), 64, None,
        lambda r: {"x": r.standard_normal((h, w), dtype=np.float32),
                   "y": np.zeros((w, h), np.float32)},
        lambda a: {"y": a["x"].T.copy()}, rodinia="(SVI-C reordering)")


def entry_pixel_pipeline(n: int = 4096, block: int = 128, c0: float = 0.85,
                         c1: float = 0.1) -> SuiteEntry:
    """``out = exp(log(img) * c0 + c1)`` for ``img`` in [0.5, 2)."""
    if n % block:
        raise ValueError(f"pixel_pipeline: n = {n} is not a multiple of the "
                         f"block {block}")
    return SuiteEntry(
        "pixel_pipeline", ("barrier",), make_pixel_pipeline(n, block, c0, c1),
        n // block, block, None,
        lambda r: {"img": r.uniform(0.5, 2.0, n).astype(np.float32),
                   "out": np.zeros(n, np.float32)},
        lambda a: {"out": np.exp(np.log(a["img"]) * np.float32(c0)
                                 + np.float32(c1))},
        rodinia="srad extract/compress")


def build_suite(scale: int = 1) -> list[SuiteEntry]:
    """The reference's 23 entries in its order, at its sizes for
    ``scale``: 1 is test-sized, larger scales grow the streaming entries
    (and pathfinder, srad_step) as the reference's wall-clock benchmarks
    do."""
    n = 4096 * scale
    mm = 32 * max(1, scale // 4)
    return [
        entry_vecadd(n),
        entry_reverse(),
        entry_histogram(n),
        entry_reduce_shared(2048 * scale),
        entry_reduce_warp(2048 * scale),
        entry_matmul_tiled(mm),
        entry_stencil1d(n),
        entry_stencil2d(32, 64 * scale),
        entry_softmax_row(32 * scale),
        entry_scan_block(1024 * scale),
        entry_transpose_tiled(64, 64 * scale),
        entry_pixel_pipeline(n),
        entry_bfs_frontier(),
        entry_pathfinder(scale),
        entry_needle_nw(),
        entry_backprop_layer(),
        entry_lud_diag(),
        entry_srad_step(scale),
        entry_lavamd(),
        entry_nn(),
        entry_kmeans(),
        entry_streamcluster(),
        entry_hotspot(),
    ]
