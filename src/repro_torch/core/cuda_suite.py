"""CUDA-style kernel suite of the port: the four Rodinia wavefront chains.

Each entry is a kernel written in the port's IR (stages over
:class:`~repro_torch.core.kernel.Ctx`), a native descriptor naming its
hand-written CUDA kernel for the ``cuda`` backend, and a NumPy oracle:

| kernel        | Rodinia    | features exercised                              |
|---------------|------------|-------------------------------------------------|
| bfs_frontier  | bfs        | atomicCAS, atomicAdd, __syncthreads_count, const, stop-flag chain |
| pathfinder    | pathfinder | __shared__ halo, barrier, row chain             |
| needle_nw     | nw         | anti-diagonal wavefront chain                   |
| hotspot       | hotspot    | 2-D dim3, 2-D shared halo, const, ping-pong chain |

``make_args`` and ``reference`` are NumPy, with the reference package's
inputs for the same generator (the builders take size keywords whose
defaults are the reference's sizes).  The BFS and NW oracles are
vectorised (by level and by anti-diagonal) so they stay fast at Rodinia
sizes; they compute the same values as the reference's loops.
"""
from __future__ import annotations

import dataclasses
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

OOB = 1 << 30  # out-of-bounds sentinel for drop-mode stores


def _gid(ctx):
    return ctx.bid * ctx.block_dim + ctx.tid


def _where(cond, a, b):
    """``jnp.where`` over index values: int64, on ``cond``'s device."""
    return torch.where(cond, torch.as_tensor(a, device=cond.device),
                       torch.as_tensor(b, device=cond.device))


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
# Suite registry: kernel + launch config + inputs + numpy oracle
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SuiteEntry:
    """One suite workload: kernel(s), launch geometry, inputs, and oracle.

    ``chain`` is set for wavefront workloads driven by a
    :class:`~repro_torch.core.kernel.LaunchChain` (``kernel``/``grid``/
    ``block`` then describe the first step); ``const`` names buffers bound
    in ``__constant__`` space; ``tol`` is the oracle tolerance (used as
    both ``rtol`` and ``atol``).
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


def run_entry(entry: SuiteEntry, backend: str = "loop", *, rng=None,
              args: dict | None = None, grain=1, pool=None,
              with_reference: bool = True, chain_mode: str = "host",
              chain_stats: ChainStats | None = None, device=None):
    """Execute a suite entry end to end under one backend.

    The entry's :class:`LaunchChain` replays with every step routed
    through the same options (every entry of this slice is a chain).
    Inputs come from ``entry.make_args`` (seeded ``rng``, default
    ``default_rng(42)``) or ``args``, and go to ``device`` through
    :func:`repro_torch.carry.from_reference` - the card unless the caller
    asks for ``"cpu"``.  Returns ``(out, want)``: the final buffer dict
    (tensors) and the NumPy oracle's expectation (``None`` when
    ``with_reference=False``).  Only the host-hop chain mode is ported.
    """
    if chain_mode != "host":
        raise NotImplementedError(
            f"chain_mode={chain_mode!r} is not ported yet: ROADMAP 1.7 "
            f"(streams, graphs)")
    if args is None:
        args = entry.make_args(rng if rng is not None
                               else np.random.default_rng(42))
    want = entry.reference(args) if with_reference else None
    bufs = carry.from_reference(args, const=entry.const, device=device)

    def launch_step(step, b):
        return launch(step.kernel, grid=step.grid, block=step.block,
                      args=b, dyn_shared=step.dyn_shared, backend=backend,
                      grain=grain, pool=pool)

    return entry.chain.run(launch_step, bufs, stats=chain_stats), want


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

    chain = LaunchChain(
        steps=(ChainStep(kernel, grid, block, prepare=prepare),),
        repeat=n,                 # upper bound; stop flag exits early
        stop=lambda bufs: int(bufs["active"][0]) == 0,
    )
    return SuiteEntry(
        "bfs_frontier", ("atomic_cas", "warp", "const", "chain"),
        kernel, grid, block, None, margs, ref,
        chain=chain, const=("edges",), rodinia="bfs")


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

    chain = LaunchChain(
        steps=(ChainStep(kernel, grid, block, prepare=prepare),),
        repeat=rows - 1,
    )
    return SuiteEntry(
        "pathfinder", ("barrier", "chain"), kernel, grid, block, None,
        margs, ref, chain=chain, rodinia="pathfinder")


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
            prepare=lambda it, bufs: {"diag": _scalar(it + 2, bufs)}),),
        repeat=2 * n - 1,
    )
    return SuiteEntry(
        "needle_nw", ("chain",), kernel, grid, block, None, margs, ref,
        chain=chain, rodinia="nw")


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
        return {"t": bufs["t_out"], "t_out": torch.zeros_like(bufs["t_out"])}

    chain = LaunchChain(
        steps=(ChainStep(kernel, (w // 8, h // 8), (8, 8), prepare=prep),),
        repeat=iters,
    )
    return SuiteEntry(
        "hotspot", ("barrier", "dim3", "chain", "const"), kernel,
        (w // 8, h // 8), (8, 8), None, margs, ref, chain=chain,
        const=("p",), tol=1e-4, rodinia="hotspot")
