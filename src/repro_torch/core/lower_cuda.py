"""The ``cuda`` backend: hand-written Hopper kernels for suite kernels.

The Hopper counterpart of the reference's ``pallas`` backend
(``src/repro/core/pallas_emit.py:34``), which wraps any ``KernelDef`` in
one ``pl.pallas_call`` whose grid steps run the blocks' stages in order.
Here a kernel's :class:`~repro_torch.core.kernel.Native` descriptor names
a hand-written ``__global__`` (``src/repro_torch/csrc/``) that computes
the same launch, and the CUDA blocks are the blocks:

* a kernel without a descriptor raises :class:`UnsupportedKernel` - a
  Table-II 'unsupport' cell, as the coverage probes count it;
* each :class:`CudaKernel` wrapper launches its kernel on the current
  stream when the buffers lie on the card, checks the returned
  ``cudaError_t`` and raises if it is not 0, and adds one to its
  ``launches`` count;
* when the buffers lie on the CPU, and only then, the wrapper runs the
  kernel's plain PyTorch version: one launch over the whole grid,
  vectorised over all threads.  Nothing gives way from one to the other:
  a build or launch that fails raises.

Launches through ``api.launch`` are functional, like the reference's: the
written buffers are copied, the copies updated, and the inputs left
untouched.  Inside :func:`in_place` - the stream runtime's launches, eager
or captured into a graph - a launch writes the buffers it is given in
place, as a CUDA kernel does; a kernel reads its written buffers from the
copies in the functional case, so both give the same bits.  ``grain`` and
``interpret`` are accepted for the uniform backend signature and have no
effect: the card's block scheduler does the fetching.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch.core import _native, index
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import KernelDef, UnsupportedKernel

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I32, _F32 = torch.int32, torch.float32
_INT_MAX = 2**31 - 1


#: whether launches write their buffers in place (see :func:`in_place`)
_IN_PLACE = contextvars.ContextVar("repro_torch_cuda_in_place",
                                   default=False)


@contextlib.contextmanager
def in_place():
    """Launches on the card inside the block update the written buffers
    they are given in place instead of copies of them.  A launch captured
    into a CUDA graph must: its replay writes the tensors the next replay
    reads, not copies that nothing reads."""
    token = _IN_PLACE.set(True)
    try:
        yield
    finally:
        _IN_PLACE.reset(token)


def _no_scratch(bufs, **params) -> dict:
    return {}


@dataclasses.dataclass
class CudaKernel:
    """One hand-written kernel: validation, routing, and its launch count.

    ``buffers`` maps each bound buffer to its dtype; ``shapes`` gives the
    expected shape of each from the scalar parameters; ``check`` validates
    the launch geometry; ``scratch`` allocates the device scratch a launch
    needs; ``cargs`` lists the C launcher's arguments (without the
    trailing stream) for buffers on the card.  ``extern`` is the element
    type of the kernel's extern ``__shared__`` array, if it has one: its
    launches then take a ``dyn_shared`` parameter (elements, as the IR
    counts them), which ``cargs`` hands to the launcher in bytes for the
    chevron's third slot.
    """

    name: str
    symbol: str
    argtypes: tuple
    buffers: dict[str, torch.dtype]
    writes: tuple[str, ...]
    shapes: Callable[..., dict[str, tuple[int, ...]]]
    check: Callable[[Dim3, Dim3, dict], None]
    plain: Callable[..., dict]
    cargs: Callable[..., list]
    source: str
    scratch: Callable[..., dict] = _no_scratch
    extern: torch.dtype | None = None
    launches: int = 0

    def validate(self, glob: dict, grid: Dim3, block: Dim3,
                 params: dict) -> dict:
        """The kernel's buffers from ``glob``, checked; raises otherwise."""
        missing = set(self.buffers) - set(glob)
        if missing:
            raise ValueError(f"{self.name}: missing buffers {sorted(missing)}")
        bufs = {n: glob[n] for n in self.buffers}
        for n, t in bufs.items():
            if t.dtype != self.buffers[n]:
                raise UnsupportedKernel(
                    f"{self.name}: buffer {n!r} is {t.dtype}; the "
                    f"hand-written kernel takes {self.buffers[n]}")
        for n, shape in self.shapes(**params).items():
            if tuple(bufs[n].shape) != shape:
                raise ValueError(f"{self.name}: buffer {n!r} has shape "
                                 f"{tuple(bufs[n].shape)}, expected {shape}")
        self.check(grid, block, params)
        devices = {t.device for t in bufs.values()}
        if len(devices) != 1 or next(iter(devices)).type not in ("cpu",
                                                                 "cuda"):
            raise ValueError(f"{self.name}: buffers must all lie on the CPU "
                             f"or all on one CUDA device; got "
                             f"{sorted(str(d) for d in devices)}")
        return bufs

    def __call__(self, glob: dict, *, grid, block, **params) -> dict:
        """Run one launch; returns the new values of the written buffers."""
        grid, block = Dim3.of(grid), Dim3.of(block)
        bufs = self.validate(glob, grid, block, params)
        if next(iter(bufs.values())).device.type == "cpu":
            return self.plain(bufs, grid, block, **params)
        if _IN_PLACE.get():
            self.launch_into(bufs, grid, block, **params)
            return {n: bufs[n] for n in self.writes}
        outs = {n: bufs[n].clone() for n in self.writes}
        self.launch_into({**bufs, **outs}, grid, block, **params)
        return outs

    def launch_into(self, bufs: dict, grid: Dim3, block: Dim3,
                    **params) -> None:
        """Launch the kernel over ``bufs`` (all on one card, contiguous),
        updating the written buffers in place."""
        bad = [n for n, t in bufs.items() if not t.is_contiguous()]
        if bad:
            raise ValueError(f"{self.name}: buffers {bad} are not contiguous")
        work = {**bufs, **self.scratch(bufs, **params)}
        _native.launch(self.symbol, self.argtypes,
                       self.cargs(work, grid, block, **params),
                       next(iter(bufs.values())).device)
        self.launches += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _one_dim(name):
    def check(grid: Dim3, block: Dim3, params: dict):
        if grid.y * grid.z != 1 or block.y * block.z != 1:
            raise UnsupportedKernel(f"{name}: 1-D grid and block expected, "
                                    f"got {grid} x {block}")
    return check


def _halving_tree(*rows: torch.Tensor) -> list[torch.Tensor]:
    """Column 0 of each ``[blocks, width]`` tensor after the barrier tree
    that adds ``s[t + off]`` into ``s[t]`` for ``t < off``, ``off`` from
    ``width / 2`` down to 1: the kernels' order of additions."""
    rows = list(rows)
    off = rows[0].shape[1] // 2
    while off >= 1:
        rows = [r[:, :off] + r[:, off:2 * off] for r in rows]
        off //= 2
    return [r[:, 0] for r in rows]


def _block_values(b, grid: Dim3, block: Dim3, n: int) -> torch.Tensor:
    """``x[gid]`` (0 past ``n``) for every thread, as ``[grid, block]``."""
    gid = torch.arange(grid.x * block.x, device=b["x"].device)
    return torch.where(gid < n, b["x"].reshape(-1)[gid.clamp(max=n - 1)],
                       0.0).view(grid.x, block.x)


def _put_per_block(out: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[bid] = vals[bid]`` for each block, dropping ids past ``out``."""
    return index.put(out, torch.arange(vals.numel(), device=out.device),
                     vals)


# --------------------------------------------------------------------------
# bfs_frontier
# --------------------------------------------------------------------------
def bfs_frontier_plain(b, grid: Dim3, block: Dim3, *, n: int, deg: int):
    """One BFS level, each contested node going to the reference's winner.

    The reference serialises its ``atomicCAS`` claims in (block, edge
    slot, thread) order, so a node goes to the claimant first in that
    order; ``active`` gains, per block, the threads that won anything.
    Edges must lie in ``[0, n]`` (``n`` marks a padding slot).
    """
    dev = b["edges"].device
    bs = block.size
    t = torch.arange(n, device=dev)
    nbr = b["edges"].long()                                 # [n, deg]
    attempt = (b["frontier"] == 1)[:, None] & (nbr >= 0) & (nbr < n)
    nb = nbr.clamp(0, n - 1)
    claim = attempt & (b["visited"][nb] == 0)
    k = torch.arange(deg, device=dev)[None, :]
    key = ((t // bs)[:, None] * deg + k) * bs + (t % bs)[:, None]
    first = torch.full((n,), _INT_MAX, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, nb[claim], key[claim], "amin")
    won = claim & (first[nb] == key)
    wn = nb[won]
    visited, nxt, dist = (b["visited"].clone(), b["nxt"].clone(),
                          b["dist"].clone())
    visited[wn] = 1
    nxt[wn] = 1
    dist[wn] = b["level"][0] + 1
    active = b["active"] + won.any(dim=1).sum(dtype=_I32)
    return {"visited": visited, "nxt": nxt, "dist": dist, "active": active}


def _bfs_shapes(*, n, deg):
    return {"edges": (n, deg), "frontier": (n,), "visited": (n,),
            "nxt": (n,), "dist": (n,), "active": (1,), "level": (1,)}


def _bfs_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("bfs_frontier")(grid, block, params)
    n, deg = params["n"], params["deg"]
    if grid.x * block.x != n:
        raise UnsupportedKernel(f"bfs_frontier: the kernel runs one thread "
                                f"per node; grid*block = "
                                f"{grid.x * block.x} != n = {n}")
    if n * deg >= _INT_MAX:
        raise UnsupportedKernel(f"bfs_frontier: n*deg = {n * deg} claim "
                                f"keys overflow int32")


#: the launches' scratch, one for each (device, stream, n): ``owner`` is
#: INT_MAX between launches (the winners put it back), so it is filled
#: once, not on every launch (csrc/bfs_frontier.cu says why that is
#: safe); ``bids`` needs no fill
_BFS_SCRATCH: dict[tuple, dict[str, torch.Tensor]] = {}


def _bfs_scratch_key(b, n: int) -> tuple:
    dev = b["edges"].device
    return dev, torch.cuda.current_stream(dev).cuda_stream, n


def _bfs_scratch(b, *, n, deg):
    key = _bfs_scratch_key(b, n)
    if key not in _BFS_SCRATCH:
        _BFS_SCRATCH[key] = {
            "owner": torch.full((n,), _INT_MAX, dtype=_I32, device=key[0]),
            "bids": torch.empty((n,), dtype=_I32, device=key[0])}
    return _BFS_SCRATCH[key]


def bfs_frontier_cta_nodes() -> int:
    """The nodes one CTA of ``csrc/bfs_frontier.cu`` covers, as its
    ``bfs_frontier_cta_nodes`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("bfs_frontier_cta_nodes", ())()


def bfs_frontier_ctas(n: int) -> int:
    """The CTAs each pass of a launch over ``n`` nodes starts: enough
    :func:`bfs_frontier_cta_nodes`-node CTAs to hold node ``n - 1``."""
    return -(-n // bfs_frontier_cta_nodes())


class _BfsFrontierKernel(CudaKernel):
    """The bfs wrapper: a launch that raises may have left bids in its
    stream's ``owner``, so the scratch goes and the next launch fills a
    new one."""

    def launch_into(self, bufs: dict, grid: Dim3, block: Dim3,
                    **params) -> None:
        try:
            super().launch_into(bufs, grid, block, **params)
        except BaseException:
            _BFS_SCRATCH.pop(_bfs_scratch_key(bufs, params["n"]), None)
            raise


BFS_FRONTIER = _BfsFrontierKernel(
    name="bfs_frontier", symbol="launch_bfs_frontier",
    argtypes=(_P,) * 9 + (_I,) * 4 + (_P,),
    buffers={"edges": _I32, "frontier": _I32, "visited": _I32, "nxt": _I32,
             "dist": _I32, "active": _I32, "level": _I32},
    writes=("visited", "nxt", "dist", "active"),
    shapes=_bfs_shapes, check=_bfs_check, plain=bfs_frontier_plain,
    scratch=_bfs_scratch,
    cargs=lambda b, grid, block, *, n, deg: [
        _ptr(b["edges"]), _ptr(b["frontier"]), _ptr(b["owner"]),
        _ptr(b["bids"]), _ptr(b["visited"]), _ptr(b["nxt"]),
        _ptr(b["dist"]), _ptr(b["active"]), _ptr(b["level"]), n, deg,
        block.x, bfs_frontier_ctas(n)],
    source="src/repro_torch/csrc/bfs_frontier.cu")


# --------------------------------------------------------------------------
# pathfinder
# --------------------------------------------------------------------------
PATHFINDER_BLOCK = 64


def pathfinder_plain(b, grid: Dim3, block: Dim3, *, cols: int):
    """``dst[c] = wall[r, c] + min(src[c-1], src[c], src[c+1])``, clamped,
    for the columns the grid covers."""
    src = b["src"]
    m = min(cols, grid.size * block.size)
    c = torch.arange(m, device=src.device)
    best = torch.minimum(torch.minimum(src[(c - 1).clamp(0, cols - 1)],
                                       src[c]),
                         src[(c + 1).clamp(0, cols - 1)])
    dst = b["dst"].clone()
    dst[:m] = index.take(b["wall"], b["row"][0], c) + best
    return {"dst": dst}


def _pathfinder_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("pathfinder")(grid, block, params)
    if block.x != PATHFINDER_BLOCK:
        raise UnsupportedKernel(f"pathfinder: the launcher counts the "
                                f"columns in {PATHFINDER_BLOCK}-thread "
                                f"blocks, got {block.x}")


def pathfinder_cta_cols() -> int:
    """The columns one CTA of ``csrc/pathfinder.cu`` covers, as its
    ``pathfinder_cta_cols`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("pathfinder_cta_cols", ())()


def pathfinder_ctas(cols: int, grid: int, block: int) -> int:
    """The CTAs of :func:`pathfinder_cta_cols` columns that cover the
    ``m = min(cols, grid * block)`` columns a logical grid writes."""
    return -(-min(cols, grid * block) // pathfinder_cta_cols())


PATHFINDER = CudaKernel(
    name="pathfinder", symbol="launch_pathfinder",
    argtypes=(_P,) * 4 + (_I,) * 4 + (_P,),
    buffers={"wall": _I32, "src": _I32, "dst": _I32, "row": _I32},
    writes=("dst",),
    shapes=lambda *, cols: {"src": (cols,), "dst": (cols,), "row": (1,)},
    check=_pathfinder_check, plain=pathfinder_plain,
    cargs=lambda b, grid, block, *, cols: [
        _ptr(b["wall"]), _ptr(b["src"]), _ptr(b["dst"]), _ptr(b["row"]),
        b["wall"].shape[0], cols, grid.x,
        pathfinder_ctas(cols, grid.x, block.x)],
    source="src/repro_torch/csrc/pathfinder.cu")


# --------------------------------------------------------------------------
# needle_nw
# --------------------------------------------------------------------------
def needle_nw_plain(b, grid: Dim3, block: Dim3, *, n: int, penalty: int):
    """One anti-diagonal ``d = diag[0]`` of the Needleman-Wunsch matrix."""
    score, sim = b["score"], b["sim"]
    t = torch.arange(grid.size * block.size, device=score.device)
    d = b["diag"][0].long()
    lo, hi = (d - n).clamp(min=1), (d - 1).clamp(max=n)
    valid = t <= hi - lo
    i = (t + lo).clamp(1, n)
    j = (d - i).clamp(1, n)
    dv = score[i - 1, j - 1] + sim[i - 1, j - 1]
    up = score[i - 1, j] - penalty
    lf = score[i, j - 1] - penalty
    v = torch.maximum(dv, torch.maximum(up, lf))
    return {"score": index.put(score, (i.masked_fill(~valid, n + 1), j), v)}


def needle_nw_cta_threads() -> int:
    """The threads of one CTA of ``csrc/needle_nw.cu``, as its
    ``needle_nw_cta_threads`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("needle_nw_cta_threads", ())()


def needle_nw_ctas(grid: int, block: int) -> int:
    """The CTAs of :func:`needle_nw_cta_threads` threads that hold the
    ``grid * block`` threads of the logical grid, thread ``t`` in CTA
    ``t // needle_nw_cta_threads()``."""
    return -(-grid * block // needle_nw_cta_threads())


NEEDLE_NW = CudaKernel(
    name="needle_nw", symbol="launch_needle_nw",
    argtypes=(_P,) * 3 + (_I,) * 5 + (_P,),
    buffers={"score": _I32, "sim": _I32, "diag": _I32},
    writes=("score",),
    shapes=lambda *, n, penalty: {"score": (n + 1, n + 1), "sim": (n, n),
                                  "diag": (1,)},
    check=_one_dim("needle_nw"), plain=needle_nw_plain,
    cargs=lambda b, grid, block, *, n, penalty: [
        _ptr(b["score"]), _ptr(b["sim"]), _ptr(b["diag"]), n, penalty,
        grid.x, block.x, needle_nw_ctas(grid.x, block.x)],
    source="src/repro_torch/csrc/needle_nw.cu")


# --------------------------------------------------------------------------
# hotspot
# --------------------------------------------------------------------------
HOTSPOT_TILE = 8


def hotspot_plain(b, grid: Dim3, block: Dim3, *, h: int, w: int, cap: float,
                  rx: float, ry: float, rz: float, amb: float):
    """One RC thermal step over the cells the grid covers, edges clamped."""
    t = b["t"]
    nr, nc = min(h, grid.y * block.y), min(w, grid.x * block.x)
    r = torch.arange(nr, device=t.device)[:, None]
    c = torch.arange(nc, device=t.device)[None, :]

    def at(rr, cc):
        return t[rr.clamp(0, h - 1), cc.clamp(0, w - 1)]

    tc = t[:nr, :nc]
    v = tc + cap * (
        b["p"][:nr, :nc]
        + ry * (at(r - 1, c) + at(r + 1, c) - 2.0 * tc)
        + rx * (at(r, c - 1) + at(r, c + 1) - 2.0 * tc)
        + rz * (amb - tc))
    t_out = b["t_out"].clone()
    t_out[:nr, :nc] = v
    return {"t_out": t_out}


def _tile_2d(name: str, t: int):
    """The check of a kernel whose ``t`` x ``t`` blocks stage a haloed
    ``__shared__`` tile over a 2-D grid."""
    def check(grid: Dim3, block: Dim3, params: dict):
        if block != Dim3(t, t) or grid.z != 1:
            raise UnsupportedKernel(f"{name}: the kernel's shared tile is "
                                    f"{t}x{t} over a 2-D grid; got {grid} "
                                    f"x {block}")
    return check


def hotspot_region() -> tuple[int, int]:
    """The rows and columns of cells one CTA of ``csrc/hotspot.cu``
    covers, as its ``hotspot_cta_rows`` / ``hotspot_cta_cols`` give them
    (builds the kernels' library at first use)."""
    return (_native.function("hotspot_cta_rows", ())(),
            _native.function("hotspot_cta_cols", ())())


def tile_grid_ctas(h: int, w: int, grid, region: tuple[int, int],
                   tile: int) -> tuple[int, int]:
    """The physical grid ``(x, y)`` of CTAs of ``region`` (rows, columns)
    that covers the cells a logical ``grid`` of ``tile`` x ``tile`` blocks
    writes in an ``[h, w]`` array: rows below ``min(h, tile grid.y)``,
    columns below ``min(w, tile grid.x)``."""
    grid = Dim3.of(grid)
    rows, cols = region
    nr = min(h, grid.y * tile)
    nc = min(w, grid.x * tile)
    return -(-nc // cols), -(-nr // rows)


def hotspot_ctas(h: int, w: int, grid) -> tuple[int, int]:
    """The physical grid ``(x, y)`` of :func:`hotspot_region` CTAs that
    covers the cells a logical ``grid`` of 8 x 8 tiles writes in an ``[h,
    w]`` array."""
    return tile_grid_ctas(h, w, grid, hotspot_region(), HOTSPOT_TILE)


HOTSPOT = CudaKernel(
    name="hotspot", symbol="launch_hotspot",
    argtypes=(_P,) * 3 + (_I,) * 2 + (_F,) * 5 + (_I,) * 4 + (_P,),
    buffers={"t": _F32, "p": _F32, "t_out": _F32},
    writes=("t_out",),
    shapes=lambda *, h, w, **_: {"t": (h, w), "p": (h, w), "t_out": (h, w)},
    check=_tile_2d("hotspot", HOTSPOT_TILE), plain=hotspot_plain,
    cargs=lambda b, grid, block, *, h, w, cap, rx, ry, rz, amb: [
        _ptr(b["t"]), _ptr(b["p"]), _ptr(b["t_out"]), h, w, cap, rx, ry, rz,
        amb, grid.x, grid.y, *hotspot_ctas(h, w, grid)],
    source="src/repro_torch/csrc/hotspot.cu")


# --------------------------------------------------------------------------
# backprop_layer
# --------------------------------------------------------------------------
#: CUDA's widest block; a unit runs at least min(in_n, BACKPROP_THREADS)
#: threads (:func:`backprop_layer_threads`), so a thread owns at most
#: BACKPROP_MAX_PER_THREAD of a logical block's inputs
BACKPROP_THREADS = 1024
BACKPROP_MAX_PER_THREAD = 64     # instantiated in csrc/backprop_layer.cu
#: the largest thread-block cluster a hidden unit runs on, and the widest
#: of its CTAs (at most 16 and 256, csrc/backprop_layer.cu's limits; their
#: product at least BACKPROP_THREADS); tools/backprop_layer_variants.cu
#: times the choices
BACKPROP_CLUSTER = 8
BACKPROP_CTA_THREADS = 256


def backprop_layer_plain(bufs, grid: Dim3, block: Dim3, *, in_n: int,
                         out_n: int, lr: float):
    """The hidden units the grid covers: the reference's barrier tree
    (offsets ``in_n/2`` down to 1) over ``inp * w``, a sigmoid, and the
    weight update ``w + lr * delta * inp``."""
    rows = grid.x
    w, inp = bufs["w"][:rows], bufs["inp"]
    total = _halving_tree(inp[None, :] * w)[0] + bufs["bias"][:rows]
    hidden, w_out = bufs["hidden"].clone(), bufs["w_out"].clone()
    hidden[:rows] = 1.0 / (1.0 + torch.exp(-total))
    w_out[:rows] = w + lr * bufs["delta"][:rows, None] * inp[None, :]
    return {"hidden": hidden, "w_out": w_out}


def _backprop_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("backprop_layer")(grid, block, params)
    in_n, out_n = params["in_n"], params["out_n"]
    if block.x != in_n:
        raise UnsupportedKernel(f"backprop_layer: the tree runs one logical "
                                f"thread per input; block {block.x} != "
                                f"in_n {in_n}")
    if in_n > BACKPROP_THREADS * BACKPROP_MAX_PER_THREAD:
        raise UnsupportedKernel(f"backprop_layer: in_n {in_n} exceeds the "
                                f"kernel's {BACKPROP_MAX_PER_THREAD} inputs "
                                f"per thread")
    if grid.x > out_n:
        raise UnsupportedKernel(f"backprop_layer: grid {grid.x} exceeds "
                                f"out_n {out_n}")


def backprop_layer_ctas(in_n: int, grid: int) -> tuple[int, int]:
    """``(CTAs, C)``: the physical CTAs that run ``grid`` hidden units of
    ``in_n`` inputs, a cluster of C CTAs a unit.  C is the largest power
    of two up to BACKPROP_CLUSTER that divides in_n and leaves each CTA at
    least a warp of the unit's inputs (C = 1 below 64 inputs)."""
    most = min(BACKPROP_CLUSTER, in_n // 32)
    c = 1
    while 2 * c <= most and in_n % (2 * c) == 0:
        c *= 2
    return grid * c, c


def backprop_layer_threads(in_n: int) -> int:
    """T, the threads that run one hidden unit of ``in_n`` inputs: C CTAs
    (:func:`backprop_layer_ctas`) of up to BACKPROP_CTA_THREADS threads,
    one input a thread at most; thread t owns the inputs t + T m."""
    c = backprop_layer_ctas(in_n, 1)[1]
    return min(in_n, c * BACKPROP_CTA_THREADS)


BACKPROP_LAYER = CudaKernel(
    name="backprop_layer", symbol="launch_backprop_layer",
    argtypes=(_P,) * 6 + (_I, _F, _I, _I, _I) + (_P,),
    buffers={"inp": _F32, "w": _F32, "bias": _F32, "delta": _F32,
             "hidden": _F32, "w_out": _F32},
    writes=("hidden", "w_out"),
    shapes=lambda *, in_n, out_n, lr: {
        "inp": (in_n,), "w": (out_n, in_n), "bias": (out_n,),
        "delta": (out_n,), "hidden": (out_n,), "w_out": (out_n, in_n)},
    check=_backprop_check, plain=backprop_layer_plain,
    cargs=lambda b, grid, block, *, in_n, out_n, lr: [
        _ptr(b["inp"]), _ptr(b["w"]), _ptr(b["bias"]), _ptr(b["delta"]),
        _ptr(b["hidden"]), _ptr(b["w_out"]), in_n, lr, grid.x,
        backprop_layer_threads(in_n), backprop_layer_ctas(in_n, grid.x)[1]],
    source="src/repro_torch/csrc/backprop_layer.cu")


# --------------------------------------------------------------------------
# lud_diag
# --------------------------------------------------------------------------
LUD_MAX_B = 32                   # a tile's rows on one warp's lanes


def lud_diag_plain(bufs, grid: Dim3, block: Dim3, *, ntiles: int, b: int):
    """Doolittle LU (no pivoting) of each diagonal tile the grid covers,
    step by step as the reference's threads do it."""
    t = grid.x
    s = bufs["a"][:t * b].reshape(t, b, b).clone()
    cols = torch.arange(b, device=s.device)
    for k in range(b - 1):
        m = s[:, k + 1:, k] / s[:, k:k + 1, k]
        upd = torch.where(cols[None, :] > k, s[:, k, :], 0.0)
        s[:, k + 1:, :] = s[:, k + 1:, :] - m[:, :, None] * upd[:, None, :]
        s[:, k + 1:, k] = m
    lu = bufs["lu"].clone()
    lu[:t * b] = s.reshape(t * b, b)
    return {"lu": lu}


def _lud_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("lud_diag")(grid, block, params)
    ntiles, b = params["ntiles"], params["b"]
    if block.x != b or not 1 <= b <= LUD_MAX_B:
        raise UnsupportedKernel(f"lud_diag: one thread per row of a tile of "
                                f"at most {LUD_MAX_B} rows; got block "
                                f"{block.x}, b = {b}")
    if grid.x > ntiles:
        raise UnsupportedKernel(f"lud_diag: grid {grid.x} exceeds ntiles "
                                f"{ntiles}")


def lud_diag_cta_tiles(b: int) -> int:
    """The tiles of ``b`` rows one CTA of ``csrc/lud_diag.cu`` holds, as
    its ``lud_diag_cta_tiles`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("lud_diag_cta_tiles", (_I,))(b)


def lud_diag_ctas(b: int, grid: int) -> int:
    """The CTAs of :func:`lud_diag_cta_tiles` tiles that cover the
    ``grid`` tiles of ``b`` rows a launch factors."""
    per = lud_diag_cta_tiles(b)
    return -(-grid // per)


LUD_DIAG = CudaKernel(
    name="lud_diag", symbol="launch_lud_diag",
    argtypes=(_P,) * 2 + (_I,) * 3 + (_P,),
    buffers={"a": _F32, "lu": _F32},
    writes=("lu",),
    shapes=lambda *, ntiles, b: {"a": (ntiles * b, b),
                                 "lu": (ntiles * b, b)},
    check=_lud_check, plain=lud_diag_plain,
    cargs=lambda bf, grid, block, *, ntiles, b: [
        _ptr(bf["a"]), _ptr(bf["lu"]), b, grid.x, lud_diag_ctas(b, grid.x)],
    source="src/repro_torch/csrc/lud_diag.cu")


# --------------------------------------------------------------------------
# lavamd
# --------------------------------------------------------------------------
def lavamd_plain(bufs, grid: Dim3, block: Dim3, *, nboxes: int, ppb: int,
                 nnei: int, alpha: float):
    """The potential of every particle in the home boxes the grid covers,
    one neighbour at a time: ``acc += sum_j q_j exp(-alpha (x - y_j)^2)``.
    Temporaries stay at ``boxes x ppb x ppb``."""
    boxes = grid.x
    pos, q = bufs["pos"], bufs["q"]
    t = torch.arange(ppb, device=pos.device)
    x = pos[:boxes * ppb].reshape(boxes, ppb)
    acc = torch.zeros_like(x)
    for k in range(nnei):
        src = bufs["nbr"][:boxes, k].long()[:, None] * ppb + t[None, :]
        d = x[:, :, None] - index.take(pos, src)[:, None, :]
        u = torch.sum(index.take(q, src)[:, None, :]
                      * torch.exp(-alpha * d * d), dim=2)
        acc = acc + u
    force = bufs["force"].clone()
    force[:boxes * ppb] = acc.reshape(-1)
    return {"force": force}


def _lavamd_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("lavamd")(grid, block, params)
    if block.x != params["ppb"] or block.x > 1024:
        raise UnsupportedKernel(f"lavamd: one thread per particle of a box "
                                f"(ppb <= 1024); got block {block.x}, ppb = "
                                f"{params['ppb']}")
    if grid.x > params["nboxes"]:
        raise UnsupportedKernel(f"lavamd: grid {grid.x} exceeds nboxes "
                                f"{params['nboxes']}")


def lavamd_cta(ppb: int, nnei: int) -> tuple[int, int]:
    """The threads of one CTA of ``csrc/lavamd.cu`` (a CTA a home box) and
    the neighbour boxes it stages together, as its launcher picks them
    (builds the kernels' library at first use)."""
    return (_native.function("lavamd_cta_threads", (_I, _I))(ppb, nnei),
            _native.function("lavamd_chunk", (_I, _I))(ppb, nnei))


LAVAMD = CudaKernel(
    name="lavamd", symbol="launch_lavamd",
    argtypes=(_P,) * 4 + (_I,) * 3 + (_F, _I) + (_P,),
    buffers={"pos": _F32, "q": _F32, "nbr": _I32, "force": _F32},
    writes=("force",),
    shapes=lambda *, nboxes, ppb, nnei, alpha: {
        "pos": (nboxes * ppb,), "q": (nboxes * ppb,), "nbr": (nboxes, nnei),
        "force": (nboxes * ppb,)},
    check=_lavamd_check, plain=lavamd_plain,
    cargs=lambda b, grid, block, *, nboxes, ppb, nnei, alpha: [
        _ptr(b["pos"]), _ptr(b["q"]), _ptr(b["nbr"]), _ptr(b["force"]),
        nboxes, ppb, nnei, alpha, grid.x],
    source="src/repro_torch/csrc/lavamd.cu")


# --------------------------------------------------------------------------
# streamcluster
# --------------------------------------------------------------------------
def streamcluster_plain(bufs, grid: Dim3, block: Dim3, *, n: int, k: int):
    """One pgain evaluation over the points the grid covers.  Every result
    is order-free: sums of integer savings, and ``ndirty`` gains one for
    each distinct centre whose flag a switcher turns from 0 to 1."""
    m = min(n, grid.size * block.size)
    a = bufs["assign"][:m].long()
    px, py = bufs["px"][:m], bufs["py"][:m]
    cand = bufs["cand"]
    dcur = ((px - index.take(bufs["cx"], a)) ** 2
            + (py - index.take(bufs["cy"], a)) ** 2)
    dcand = (px - cand[0]) ** 2 + (py - cand[1]) ** 2
    sw = dcand < dcur
    save = dcur - dcand
    ok = sw & (a >= 0) & (a < k)       # drop-mode: no slot past k
    claimed = torch.unique(a[ok])
    fresh = bufs["dirty"][claimed] == 0
    dirty, switched = bufs["dirty"].clone(), bufs["switched"].clone()
    dirty[claimed[fresh]] = 1
    switched[:m][sw] = 1
    return {"gain": bufs["gain"] + save[sw].sum().to(_I32),
            "csave": bufs["csave"].index_add(0, a[ok], save[ok]),
            "dirty": dirty,
            "ndirty": bufs["ndirty"] + fresh.sum().to(_I32),
            "switched": switched}


def _streamcluster_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("streamcluster")(grid, block, params)
    if block.x % 32 or block.x > 1024:
        raise UnsupportedKernel(f"streamcluster: the gain is summed per "
                                f"full warp; block {block.x} is not a "
                                f"multiple of 32 up to 1024")


def streamcluster_cta_points() -> int:
    """The points one CTA of ``csrc/streamcluster.cu`` covers, as its
    ``streamcluster_cta_points`` gives them (builds the kernels' library
    at first use)."""
    return _native.function("streamcluster_cta_points", ())()


def streamcluster_ctas(n: int, grid: int, block: int) -> int:
    """The CTAs of :func:`streamcluster_cta_points` points that cover the
    m = min(n, grid * block) points a logical grid of ``grid`` blocks of
    ``block`` threads evaluates."""
    m = min(n, grid * block)
    per = streamcluster_cta_points()
    return -(-m // per)


STREAMCLUSTER = CudaKernel(
    name="streamcluster", symbol="launch_streamcluster",
    argtypes=(_P,) * 11 + (_I,) * 5 + (_P,),
    buffers={name: _I32 for name in (
        "px", "py", "cx", "cy", "cand", "assign", "gain", "csave", "dirty",
        "ndirty", "switched")},
    writes=("gain", "csave", "dirty", "ndirty", "switched"),
    shapes=lambda *, n, k: {
        "px": (n,), "py": (n,), "assign": (n,), "switched": (n,),
        "cx": (k,), "cy": (k,), "csave": (k,), "dirty": (k,), "cand": (2,),
        "gain": (1,), "ndirty": (1,)},
    check=_streamcluster_check, plain=streamcluster_plain,
    cargs=lambda b, grid, block, *, n, k: [
        *(_ptr(b[name]) for name in (
            "px", "py", "cx", "cy", "cand", "assign", "gain", "csave",
            "dirty", "ndirty", "switched")),
        n, k, grid.x, block.x, streamcluster_ctas(n, grid.x, block.x)],
    source="src/repro_torch/csrc/streamcluster.cu")


# --------------------------------------------------------------------------
# srad_stats, srad_update
# --------------------------------------------------------------------------
SRAD_TILE = 8


def _pow2_block(name: str, block: Dim3, nthreads: int) -> None:
    b = block.x
    if b < 1 or b & (b - 1) or b > 1024 or b != nthreads:
        raise UnsupportedKernel(f"{name}: the tree runs over a block of "
                                f"{nthreads} threads, a power of two up to "
                                f"1024; got block {b}")


def srad_stats_plain(b, grid: Dim3, block: Dim3, *, h: int, w: int,
                     nthreads: int):
    """Per-block sums of ``x`` and ``x * x``, in the tree's order."""
    v = _block_values(b, grid, block, h * w)
    s1, s2 = _halving_tree(v, v * v)
    return {"psum": _put_per_block(b["psum"], s1),
            "psq": _put_per_block(b["psq"], s2)}


def _srad_stats_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("srad_stats")(grid, block, params)
    _pow2_block("srad_stats", block, params["nthreads"])
    if params["h"] * params["w"] >= _INT_MAX:
        raise UnsupportedKernel("srad_stats: h*w overflows int32")


SRAD_STATS = CudaKernel(
    name="srad_stats", symbol="launch_srad_stats",
    argtypes=(_P,) * 3 + (_I,) * 5 + (_P,),
    buffers={"x": _F32, "psum": _F32, "psq": _F32},
    writes=("psum", "psq"),
    shapes=lambda *, h, w, nthreads: {
        "x": (h, w), "psum": (h * w // nthreads,),
        "psq": (h * w // nthreads,)},
    check=_srad_stats_check, plain=srad_stats_plain,
    cargs=lambda b, grid, block, *, h, w, nthreads: [
        _ptr(b["x"]), _ptr(b["psum"]), _ptr(b["psq"]), h * w,
        b["psum"].numel(), b["psq"].numel(), grid.x, block.x],
    source="src/repro_torch/csrc/srad.cu")


def srad_update_plain(b, grid: Dim3, block: Dim3, *, h: int, w: int,
                      lam: float):
    """One diffusion step over the pixels the grid covers, edges clamped,
    with q0 from the totals of the partials."""
    x = b["x"]
    npix = h * w
    mean = torch.sum(b["psum"]) / npix
    var = torch.sum(b["psq"]) / npix - mean * mean
    q0 = var / (mean * mean)
    nr, nc = min(h, grid.y * block.y), min(w, grid.x * block.x)
    r = torch.arange(nr, device=x.device)[:, None]
    c = torch.arange(nc, device=x.device)[None, :]

    def at(rr, cc):
        return x[rr.clamp(0, h - 1), cc.clamp(0, w - 1)]

    xc = x[:nr, :nc]
    dn, ds = at(r - 1, c) - xc, at(r + 1, c) - xc
    dw, de = at(r, c - 1) - xc, at(r, c + 1) - xc
    g2 = (dn * dn + ds * ds + dw * dw + de * de) / (xc * xc)
    ll = (dn + ds + dw + de) / xc
    num = 0.5 * g2 - 0.0625 * (ll * ll)
    den = (1.0 + 0.25 * ll) * (1.0 + 0.25 * ll)
    q = num / den
    cd = (1.0 / (1.0 + (q - q0) / (q0 * (1.0 + q0)))).clamp(0.0, 1.0)
    y = b["y"].clone()
    y[:nr, :nc] = xc + 0.25 * lam * cd * (dn + ds + dw + de)
    return {"y": y}


def srad_update_region() -> tuple[int, int]:
    """The rows and columns of pixels one stencil CTA of ``csrc/srad.cu``
    covers, as its ``srad_update_cta_rows`` / ``srad_update_cta_cols``
    give them (builds the kernels' library at first use)."""
    return (_native.function("srad_update_cta_rows", ())(),
            _native.function("srad_update_cta_cols", ())())


def srad_update_ctas(h: int, w: int, grid) -> tuple[int, int]:
    """The physical grid ``(x, y)`` of :func:`srad_update_region` CTAs
    that covers the pixels a logical ``grid`` of 8 x 8 tiles writes in an
    ``[h, w]`` image."""
    return tile_grid_ctas(h, w, grid, srad_update_region(), SRAD_TILE)


SRAD_UPDATE = CudaKernel(
    name="srad_update", symbol="launch_srad_update",
    argtypes=(_P,) * 5 + (_I,) * 4 + (_F,) * 2 + (_I,) * 4 + (_P,),
    buffers={"x": _F32, "psum": _F32, "psq": _F32, "y": _F32},
    writes=("y",),
    shapes=lambda *, h, w, lam: {"x": (h, w), "y": (h, w)},
    check=_tile_2d("srad_update", SRAD_TILE), plain=srad_update_plain,
    # the launch's q0 and q0 (1 + q0): the fold pass writes them, the
    # stencil reads them
    scratch=lambda b, **_: {"tot": torch.empty(2, dtype=_F32,
                                               device=b["x"].device)},
    cargs=lambda b, grid, block, *, h, w, lam: [
        _ptr(b["x"]), _ptr(b["psum"]), _ptr(b["psq"]), _ptr(b["tot"]),
        _ptr(b["y"]), h, w, b["psum"].numel(), b["psq"].numel(),
        float(h * w), 0.25 * lam, grid.x, grid.y,
        *srad_update_ctas(h, w, grid)],
    source="src/repro_torch/csrc/srad.cu")


# --------------------------------------------------------------------------
# nn_reduce, nn_select
# --------------------------------------------------------------------------
def _argmin_tree(v: torch.Tensor, i: torch.Tensor):
    """Position 0's pair of each row after the reference's halving tree
    over the last axis (a power of two wide): for ``off`` from half the
    width down to 1, position ``t < off`` takes the pair at ``t + off``
    when its value is less, or equal with a lower index.  Without NaN that
    is the least (value, index) pair; a NaN on the left is never replaced
    and one on the right never taken, so with NaN the result depends on
    where it sits, and only these pairs in this operand order give the
    kernels' (and the reference's) pair."""
    off = v.shape[-1] // 2
    while off >= 1:
        v1, v2 = v[..., :off], v[..., off:2 * off]
        i1, i2 = i[..., :off], i[..., off:2 * off]
        take = (v2 < v1) | ((v2 == v1) & (i2 < i1))
        v, i = torch.where(take, v2, v1), torch.where(take, i2, i1)
        off //= 2
    return v[..., 0], i[..., 0]


def nn_reduce_plain(b, grid: Dim3, block: Dim3, *, n: int, nthreads: int):
    """Each block's nearest untaken record to the target."""
    nb, bs = grid.x, block.x
    i = torch.arange(nb * bs, device=b["lat"].device)
    g = i.clamp(max=n - 1)
    tgt = b["target"]
    dx, dy = b["lat"][g] - tgt[0], b["lng"][g] - tgt[1]
    d = torch.where((i < n) & (b["taken"][g] == 0), dx * dx + dy * dy,
                    torch.inf)
    val, win = _argmin_tree(d.view(nb, bs), g.view(nb, bs))
    bid = torch.arange(nb, device=d.device)
    return {"pval": index.put(b["pval"], bid, val),
            "pidx": index.put(b["pidx"], bid, win)}


def nn_reduce_cta_threads() -> int:
    """The threads of one CTA of ``csrc/nn.cu``'s nn_reduce, as its
    ``nn_reduce_cta_threads`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("nn_reduce_cta_threads", ())()


def nn_reduce_ctas(grid: int, block: int) -> int:
    """The CTAs of :func:`nn_reduce_cta_threads` threads that nn_reduce's
    launcher starts for ``grid`` logical blocks of ``block`` records: a
    warp a block, or 32/block blocks a warp below 32."""
    warps = -(-grid * min(block, 32) // 32)
    per = nn_reduce_cta_threads() // 32
    return -(-warps // per)


def _nn_reduce_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("nn_reduce")(grid, block, params)
    _pow2_block("nn_reduce", block, params["nthreads"])


NN_REDUCE = CudaKernel(
    name="nn_reduce", symbol="launch_nn_reduce",
    argtypes=(_P,) * 6 + (_I,) * 5 + (_P,),
    buffers={"lat": _F32, "lng": _F32, "target": _F32, "taken": _I32,
             "pval": _F32, "pidx": _I32},
    writes=("pval", "pidx"),
    shapes=lambda *, n, nthreads: {"lat": (n,), "lng": (n,), "taken": (n,),
                                   "target": (2,)},
    check=_nn_reduce_check, plain=nn_reduce_plain,
    cargs=lambda b, grid, block, *, n, nthreads: [
        _ptr(b["lat"]), _ptr(b["lng"]), _ptr(b["target"]), _ptr(b["taken"]),
        _ptr(b["pval"]), _ptr(b["pidx"]), n, b["pval"].numel(),
        b["pidx"].numel(), grid.x, block.x],
    source="src/repro_torch/csrc/nn.cu")


def nn_select_plain(b, grid: Dim3, block: Dim3, *, nblocks: int):
    """The least of the partials goes to output slot ``step[0]``, and its
    record is marked taken."""
    val, win = _argmin_tree(b["pval"], b["pidx"])
    step = b["step"][0]
    return {"out_d": index.put(b["out_d"], step, val),
            "out_i": index.put(b["out_i"], step, win),
            "taken": index.put(b["taken"], win, 1)}


def _nn_select_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("nn_select")(grid, block, params)
    _pow2_block("nn_select", block, params["nblocks"])


NN_SELECT = CudaKernel(
    name="nn_select", symbol="launch_nn_select",
    argtypes=(_P,) * 6 + (_I,) * 5 + (_P,),
    buffers={"pval": _F32, "pidx": _I32, "step": _I32, "out_d": _F32,
             "out_i": _I32, "taken": _I32},
    writes=("out_d", "out_i", "taken"),
    shapes=lambda *, nblocks: {"pval": (nblocks,), "pidx": (nblocks,),
                               "step": (1,)},
    check=_nn_select_check, plain=nn_select_plain,
    cargs=lambda b, grid, block, *, nblocks: [
        _ptr(b["pval"]), _ptr(b["pidx"]), _ptr(b["step"]), _ptr(b["out_d"]),
        _ptr(b["out_i"]), _ptr(b["taken"]), b["out_d"].numel(),
        b["out_i"].numel(), b["taken"].numel(), grid.x, block.x],
    source="src/repro_torch/csrc/nn.cu")


# --------------------------------------------------------------------------
# kmeans_assign, kmeans_update
# --------------------------------------------------------------------------
KMEANS_MAX_K = 32                # the assign kernel's __shared__ bins


def kmeans_assign_plain(b, grid: Dim3, block: Dim3, *, n: int, k: int):
    """Nearest centroid of each point the grid covers (ties to the lower
    centre), with the per-cluster sums, counts and moved points added."""
    m = min(n, grid.size * block.size)
    px, py, cx, cy = b["px"][:m], b["py"][:m], b["cx"], b["cy"]

    def dist(c):
        dx, dy = px - cx[c], py - cy[c]
        return dx * dx + dy * dy

    best = torch.zeros(m, dtype=_I32, device=px.device)
    bestd = dist(0)
    for c in range(1, k):
        dc = dist(c)
        closer = dc < bestd
        best = torch.where(closer, c, best)
        bestd = torch.where(closer, dc, bestd)
    moved = (b["assign"][:m] != best).sum(dtype=_I32)
    assign = b["assign"].clone()
    assign[:m] = best
    lbl = best.long()
    return {"assign": assign, "changed": b["changed"] + moved,
            "sumx": b["sumx"].index_add(0, lbl, px),
            "sumy": b["sumy"].index_add(0, lbl, py),
            "count": b["count"] + torch.bincount(lbl, minlength=k).to(_I32)}


def _kmeans_assign_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("kmeans_assign")(grid, block, params)
    if block.x % 32 or block.x > 1024:
        raise UnsupportedKernel(f"kmeans_assign: the sums are reduced per "
                                f"full warp; block {block.x} is not a "
                                f"multiple of 32 up to 1024")
    if not 1 <= params["k"] <= KMEANS_MAX_K:
        raise UnsupportedKernel(f"kmeans_assign: k = {params['k']}; the "
                                f"kernel holds 1 to {KMEANS_MAX_K} clusters")


def kmeans_assign_cta_points() -> int:
    """The points one CTA of ``csrc/kmeans.cu``'s assign kernel covers, as
    its ``kmeans_assign_cta_points`` gives them (builds the kernels'
    library at first use)."""
    return _native.function("kmeans_assign_cta_points", ())()


def kmeans_assign_ctas(n: int, grid: int, block: int) -> int:
    """The CTAs of :func:`kmeans_assign_cta_points` points that cover the
    m = min(n, grid * block) points a logical grid of ``grid`` blocks of
    ``block`` threads assigns."""
    m = min(n, grid * block)
    per = kmeans_assign_cta_points()
    return -(-m // per)


KMEANS_ASSIGN = CudaKernel(
    name="kmeans_assign", symbol="launch_kmeans_assign",
    argtypes=(_P,) * 9 + (_I,) * 5 + (_P,),
    buffers={"px": _F32, "py": _F32, "cx": _F32, "cy": _F32,
             "assign": _I32, "changed": _I32, "sumx": _F32, "sumy": _F32,
             "count": _I32},
    writes=("assign", "changed", "sumx", "sumy", "count"),
    shapes=lambda *, n, k: {
        "px": (n,), "py": (n,), "assign": (n,), "cx": (k,), "cy": (k,),
        "sumx": (k,), "sumy": (k,), "count": (k,), "changed": (1,)},
    check=_kmeans_assign_check, plain=kmeans_assign_plain,
    cargs=lambda b, grid, block, *, n, k: [
        *(_ptr(b[name]) for name in (
            "px", "py", "cx", "cy", "assign", "changed", "sumx", "sumy",
            "count")),
        n, k, grid.x, block.x, kmeans_assign_ctas(n, grid.x, block.x)],
    source="src/repro_torch/csrc/kmeans.cu")


def kmeans_update_plain(b, grid: Dim3, block: Dim3, *, k: int):
    """Each cluster's centroid: its sums over its count (IEEE division;
    over 1 where the count is negative); an empty cluster keeps its
    centroid."""
    cnt = b["count"]
    safe = cnt.clamp(min=1).to(_F32)
    empty = cnt == 0
    return {"cx": torch.where(empty, b["cx"], b["sumx"] / safe),
            "cy": torch.where(empty, b["cy"], b["sumy"] / safe)}


def _kmeans_update_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("kmeans_update")(grid, block, params)
    if grid.x != params["k"]:
        raise UnsupportedKernel(f"kmeans_update: one block per cluster; "
                                f"grid {grid.x} != k = {params['k']}")


def kmeans_update_cta_threads() -> int:
    """The threads of the widest CTA of ``csrc/kmeans.cu``'s update, as its
    ``kmeans_update_cta_threads`` gives them (builds the kernels' library
    at first use)."""
    return _native.function("kmeans_update_cta_threads", ())()


def kmeans_update_ctas(k: int) -> int:
    """The CTAs that kmeans_update's launcher starts for ``k`` clusters: a
    lane a cluster, up to :func:`kmeans_update_cta_threads` lanes a CTA."""
    warps = -(-k // 32)
    return -(-warps // (kmeans_update_cta_threads() // 32))


KMEANS_UPDATE = CudaKernel(
    name="kmeans_update", symbol="launch_kmeans_update",
    argtypes=(_P,) * 5 + (_I,) * 2 + (_P,),
    buffers={"sumx": _F32, "sumy": _F32, "count": _I32, "cx": _F32,
             "cy": _F32},
    writes=("cx", "cy"),
    shapes=lambda *, k: {name: (k,) for name in (
        "sumx", "sumy", "count", "cx", "cy")},
    check=_kmeans_update_check, plain=kmeans_update_plain,
    cargs=lambda b, grid, block, *, k: [
        _ptr(b["sumx"]), _ptr(b["sumy"]), _ptr(b["count"]), _ptr(b["cx"]),
        _ptr(b["cy"]), k, block.x],
    source="src/repro_torch/csrc/kmeans.cu")


# --------------------------------------------------------------------------
# vecadd
# --------------------------------------------------------------------------
def vecadd_plain(b, grid: Dim3, block: Dim3, *, n: int):
    """``c[i] = a[i] + b[i]`` for the elements the grid covers."""
    m = min(n, grid.size * block.size)
    c = b["c"].clone()
    c[:m] = b["a"][:m] + b["b"][:m]
    return {"c": c}


def vecadd_ctas(n: int, grid: int, block: int) -> int:
    """The CTAs of 256 threads that the kernel's launcher starts for
    16-byte aligned buffers, as its ``vecadd_ctas`` gives them (builds the
    kernels' library at first use)."""
    return _native.function("vecadd_ctas", (_I,) * 3)(n, grid, block)


VECADD = CudaKernel(
    name="vecadd", symbol="launch_vecadd",
    argtypes=(_P,) * 3 + (_I,) * 3 + (_P,),
    buffers={"a": _F32, "b": _F32, "c": _F32},
    writes=("c",),
    shapes=lambda *, n: {"a": (n,), "b": (n,), "c": (n,)},
    check=_one_dim("vecadd"), plain=vecadd_plain,
    cargs=lambda b, grid, block, *, n: [
        _ptr(b["a"]), _ptr(b["b"]), _ptr(b["c"]), n, grid.x, block.x],
    source="src/repro_torch/csrc/vecadd.cu")


# --------------------------------------------------------------------------
# reverse
# --------------------------------------------------------------------------
#: extern shared memory a block gets without an opt-in attribute
_DEFAULT_DYN_SHARED_BYTES = 48 * 1024


def reverse_plain(b, grid: Dim3, block: Dim3, *, n: int, dyn_shared: int):
    """``d[t] = s[ns - 1 - t]`` for the block's threads, where ``s`` holds
    ``d``'s first ``block`` values and zeros up to its ``ns =
    dyn_shared`` elements; the ``grid`` blocks do so to the same ``d``,
    one after another, as the reference's do."""
    out = b["d"].clone()
    s = torch.zeros(dyn_shared, dtype=out.dtype, device=out.device)
    for _ in range(grid.x):
        s[:block.x] = out[:block.x]
        out[:block.x] = s.flip(0)[:block.x]
    return {"d": out}


def _reverse_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("reverse")(grid, block, params)
    ns = params["dyn_shared"]
    if ns is None:
        raise ValueError("reverse: its shared array is extern (dynamic); "
                         "pass dyn_shared= at launch")
    if block.x > params["n"]:
        raise UnsupportedKernel(f"reverse: block {block.x} exceeds d's "
                                f"{params['n']} elements")
    if ns < block.x:
        raise UnsupportedKernel(f"reverse: dyn_shared {ns} is smaller than "
                                f"the block {block.x}; the kernel would "
                                f"read past its shared array")
    if ns * _I32.itemsize > _DEFAULT_DYN_SHARED_BYTES:
        raise UnsupportedKernel(f"reverse: dyn_shared {ns} int32 exceeds "
                                f"{_DEFAULT_DYN_SHARED_BYTES} bytes")


def reverse_cta_threads() -> int:
    """The threads of ``csrc/reverse.cu``'s one CTA, as its
    ``reverse_cta_threads`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("reverse_cta_threads", ())()


REVERSE = CudaKernel(
    name="reverse", symbol="launch_reverse",
    argtypes=(_P, _I, _I, ctypes.c_size_t, _P),
    buffers={"d": _I32},
    writes=("d",),
    shapes=lambda *, n, dyn_shared: {"d": (n,)},
    check=_reverse_check, plain=reverse_plain,
    # the chevron's third slot in bytes; the IR counts int32 elements
    cargs=lambda b, grid, block, *, n, dyn_shared: [
        _ptr(b["d"]), grid.x, block.x, dyn_shared * _I32.itemsize],
    source="src/repro_torch/csrc/reverse.cu", extern=_I32)


# --------------------------------------------------------------------------
# histogram_coalesced, histogram_contiguous
# --------------------------------------------------------------------------
#: the kernel's per-block private histogram lives in dynamic shared memory
HISTOGRAM_MAX_BINS = _DEFAULT_DYN_SHARED_BYTES // 4
_LAYOUTS = {"coalesced": 0, "contiguous": 1}


def _histogram_plain(layout: str):
    def plain(b, grid: Dim3, block: Dim3, *, n: int, nbins: int,
              total_threads: int):
        """Each thread the grid covers counts its ``iters`` pixels: at
        ``gid + k * total_threads`` (coalesced) or ``gid * iters + k``
        (contiguous), ``k < iters``, those below ``n``."""
        iters = -(-n // total_threads)
        gid = torch.arange(grid.size * block.size,
                           device=b["x"].device)[:, None]
        k = torch.arange(iters, device=gid.device)[None, :]
        idx = (gid + k * total_threads if layout == "coalesced"
               else gid * iters + k)
        v = b["x"][idx[idx < n]].long()
        v = torch.where(v < 0, v + nbins, v)      # scatter rule: wrap, drop
        v = v[(v >= 0) & (v < nbins)]
        return {"hist": b["hist"] + torch.bincount(v, minlength=nbins)
                .to(_I32)}
    return plain


def _histogram_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("histogram")(grid, block, params)
    nbins = params["nbins"]
    if not 1 <= nbins <= HISTOGRAM_MAX_BINS:
        raise UnsupportedKernel(f"histogram: {nbins} bins; the kernel's "
                                f"shared histogram holds 1 to "
                                f"{HISTOGRAM_MAX_BINS}")


def histogram_cta_pixels() -> int:
    """The pixels one CTA of ``csrc/histogram.cu`` counts, as its
    ``histogram_cta_pixels`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("histogram_cta_pixels", ())()


def histogram_runs(n: int, total_threads: int, grid: int, block: int,
                   layout: str) -> tuple[int, int, int]:
    """The pixels the reference's threads of a launch count, with
    multiplicity, as ``(count, stride, length)``: run ``r < count`` is
    ``[r stride, min(r stride + length, n))``.  Coalesced, row ``k`` of
    the ``iters`` rows is ``[k T, k T + G)`` for ``T = total_threads``
    and ``G = grid * block``; the rows tile ``[0, n)`` when ``G = T`` and
    overlap when ``G > T``.  Contiguous, one run ``[0, min(n, G iters))``.
    The launcher computes the same."""
    iters = -(-n // total_threads)
    threads = grid * block
    if layout == "contiguous":
        return 1, 0, min(n, threads * iters)
    if threads == total_threads:
        return 1, 0, n
    return iters, total_threads, min(threads, n)


def histogram_ctas(n: int, total_threads: int, grid: int, block: int,
                   layout: str) -> int:
    """The CTAs of :func:`histogram_cta_pixels` pixels that cover every
    run of :func:`histogram_runs`: CTA ``b`` counts chunk ``b % chunks``
    of run ``b // chunks``."""
    count, _, length = histogram_runs(n, total_threads, grid, block, layout)
    return count * -(-length // histogram_cta_pixels())


def _histogram(layout: str) -> CudaKernel:
    return CudaKernel(
        name=f"histogram_{layout}", symbol="launch_histogram",
        argtypes=(_P,) * 2 + (_I,) * 8 + (_P,),
        buffers={"x": _I32, "hist": _I32},
        writes=("hist",),
        shapes=lambda *, n, nbins, total_threads: {"x": (n,),
                                                   "hist": (nbins,)},
        check=_histogram_check, plain=_histogram_plain(layout),
        cargs=lambda b, grid, block, *, n, nbins, total_threads: [
            _ptr(b["x"]), _ptr(b["hist"]), n, nbins, total_threads,
            -(-n // total_threads), _LAYOUTS[layout], grid.x, block.x,
            histogram_ctas(n, total_threads, grid.x, block.x, layout)],
        source="src/repro_torch/csrc/histogram.cu")


HISTOGRAM_COALESCED = _histogram("coalesced")
HISTOGRAM_CONTIGUOUS = _histogram("contiguous")


# --------------------------------------------------------------------------
# reduce_shared, reduce_warp
# --------------------------------------------------------------------------
def reduce_shared_plain(b, grid: Dim3, block: Dim3, *, n: int,
                        nthreads: int):
    """Each block's sum, in the barrier tree's order."""
    (s,) = _halving_tree(_block_values(b, grid, block, n))
    return {"out": _put_per_block(b["out"], s)}


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """``v + shfl_xor(v, off)`` for ``off`` = 16, 8, 4, 2, 1 over the
    last axis (32 lanes), level by level as the kernel adds."""
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v


def reduce_warp_plain(b, grid: Dim3, block: Dim3, *, n: int,
                      nthreads: int):
    """Each block's sum: a butterfly in each warp, then one over the warps'
    sums in warp 0 (lanes past the warp count hold 0)."""
    nwarps = block.x // 32
    per_warp = _butterfly(_block_values(b, grid, block, n)
                          .view(grid.x, nwarps, 32))[..., 0]
    lanes = torch.zeros(grid.x, 32, dtype=per_warp.dtype,
                        device=per_warp.device)
    lanes[:, :nwarps] = per_warp
    return {"out": _put_per_block(b["out"], _butterfly(lanes)[:, 0])}


def _reduce_warp_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("reduce_warp")(grid, block, params)
    if block.x % 32 or not 32 <= block.x <= 1024 \
            or block.x != params["nthreads"]:
        raise UnsupportedKernel(f"reduce_warp: whole warps, a block of "
                                f"{params['nthreads']} threads up to 1024; "
                                f"got block {block.x}")


def _reduce(name: str, plain, check) -> CudaKernel:
    return CudaKernel(
        name=name, symbol=f"launch_{name}",
        argtypes=(_P,) * 2 + (_I,) * 4 + (_P,),
        buffers={"x": _F32, "out": _F32},
        writes=("out",),
        shapes=lambda *, n, nthreads: {"x": (n,)},
        check=check, plain=plain,
        cargs=lambda b, grid, block, *, n, nthreads: [
            _ptr(b["x"]), _ptr(b["out"]), n, b["out"].numel(), grid.x,
            block.x],
        source=f"src/repro_torch/csrc/{name}.cu")


def _reduce_shared_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("reduce_shared")(grid, block, params)
    _pow2_block("reduce_shared", block, params["nthreads"])


REDUCE_SHARED = _reduce("reduce_shared", reduce_shared_plain,
                        _reduce_shared_check)
REDUCE_WARP = _reduce("reduce_warp", reduce_warp_plain, _reduce_warp_check)


# --------------------------------------------------------------------------
# matmul_tiled
# --------------------------------------------------------------------------
MATMUL_TILE = 8


def matmul_tiled_plain(b, grid: Dim3, block: Dim3, *, m: int, n: int,
                       k: int):
    """``a @ b`` accumulated one 8-deep k-tile at a time, written to the
    8 x 8 output tiles the grid covers (tile ``by * n/8 + bx``)."""
    a, bm, t = b["a"], b["b"], MATMUL_TILE
    acc = torch.zeros(m, n, dtype=a.dtype, device=a.device)
    for kk in range(0, k, t):
        acc = acc + a[:, kk:kk + t] @ bm[kk:kk + t, :]
    r = torch.arange(m, device=a.device)[:, None] // t
    c = torch.arange(n, device=a.device)[None, :] // t
    return {"c": torch.where(r * (n // t) + c < grid.x, acc, b["c"])}


def _matmul_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("matmul_tiled")(grid, block, params)
    m, n, k = params["m"], params["n"], params["k"]
    t = MATMUL_TILE
    if block.x != t * t:
        raise UnsupportedKernel(f"matmul_tiled: one thread per element of a "
                                f"{t}x{t} tile; got block {block.x}")
    if m % t or n % t or k % t:
        raise UnsupportedKernel(f"matmul_tiled: m, n, k = {m}, {n}, {k} "
                                f"are not multiples of {t}")
    if grid.x > (m // t) * (n // t):
        raise UnsupportedKernel(f"matmul_tiled: grid {grid.x} exceeds the "
                                f"{(m // t) * (n // t)} output tiles")


#: the 128 x 128 outputs of one physical CTA of ``csrc/matmul_tiled.cu``
MATMUL_CTA = 128


def matmul_tiled_ctas(n: int, grid: int) -> tuple[int, int]:
    """The physical grid ``(x, y)`` that covers a logical grid of ``grid``
    8 x 8 tiles over ``n`` columns: every CTA column, and the CTA rows
    down to the last tile row the grid reaches."""
    tile_rows = -(-grid // (n // MATMUL_TILE))
    per_cta = MATMUL_CTA // MATMUL_TILE
    return -(-n // MATMUL_CTA), -(-tile_rows // per_cta)


MATMUL_TILED = CudaKernel(
    name="matmul_tiled", symbol="launch_matmul_tiled",
    argtypes=(_P,) * 3 + (_I,) * 6 + (_P,),
    buffers={"a": _F32, "b": _F32, "c": _F32},
    writes=("c",),
    shapes=lambda *, m, n, k: {"a": (m, k), "b": (k, n), "c": (m, n)},
    check=_matmul_check, plain=matmul_tiled_plain,
    cargs=lambda b, grid, block, *, m, n, k: [
        _ptr(b["a"]), _ptr(b["b"]), _ptr(b["c"]), m, n, k, grid.x,
        *matmul_tiled_ctas(n, grid.x)],
    source="src/repro_torch/csrc/matmul_tiled.cu")


# --------------------------------------------------------------------------
# stencil1d, stencil2d
# --------------------------------------------------------------------------
#: the widest block of the kernels built for one block (stencil1d,
#: pixel_pipeline, whose reference kernels size __shared__ arrays by it) and of
#: softmax_row (its launcher's switch covers 32 ... 1024 values a row)
MAX_THREADS = 1024
STENCIL2D_TILE = 8


def _block_of(name: str, block: Dim3, nthreads: int) -> None:
    """A 1-D block of the ``nthreads`` threads the kernel was made for."""
    if block.x != nthreads or not 1 <= block.x <= MAX_THREADS:
        raise UnsupportedKernel(f"{name}: the kernel's shared array is sized "
                                f"for a block of {nthreads} threads (up to "
                                f"{MAX_THREADS}); got block {block.x}")


def _within(name: str, grid: Dim3, block: Dim3, n: int) -> None:
    """Every thread's unguarded ``x[gid]`` lies inside ``n`` elements (the
    reference's gather clamps it; the card would read past the buffer)."""
    if grid.x * block.x > n:
        raise UnsupportedKernel(f"{name}: grid*block = {grid.x * block.x} "
                                f"threads read past the {n} elements")


def stencil1d_plain(b, grid: Dim3, block: Dim3, *, n: int, nthreads: int):
    """``y[i] = 0.25 x[i-1] + 0.5 x[i] + 0.25 x[i+1]``, added left to
    right with the reads clamped, for the ``i < n`` the grid covers."""
    x = b["x"]
    m = min(n, grid.x * block.x)
    i = torch.arange(m, device=x.device)
    y = b["y"].clone()
    y[:m] = (0.25 * x[(i - 1).clamp(min=0)] + 0.5 * x[:m]
             + 0.25 * x[(i + 1).clamp(max=n - 1)])
    return {"y": y}


def _stencil1d_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("stencil1d")(grid, block, params)
    _block_of("stencil1d", block, params["nthreads"])


def stencil1d_cta_elems() -> int:
    """The elements one CTA of ``csrc/stencil1d.cu`` covers, as its
    ``stencil1d_cta_elems`` gives them (builds the kernels' library at
    first use)."""
    return _native.function("stencil1d_cta_elems", ())()


def stencil1d_ctas(n: int, grid: int, block: int) -> int:
    """The CTAs of :func:`stencil1d_cta_elems` elements that cover the
    ``m = min(n, grid * block)`` elements a logical grid writes."""
    return -(-min(n, grid * block) // stencil1d_cta_elems())


STENCIL1D = CudaKernel(
    name="stencil1d", symbol="launch_stencil1d",
    argtypes=(_P,) * 2 + (_I,) * 4 + (_P,),
    buffers={"x": _F32, "y": _F32},
    writes=("y",),
    shapes=lambda *, n, nthreads: {"x": (n,), "y": (n,)},
    check=_stencil1d_check, plain=stencil1d_plain,
    cargs=lambda b, grid, block, *, n, nthreads: [
        _ptr(b["x"]), _ptr(b["y"]), n, grid.x, block.x,
        stencil1d_ctas(n, grid.x, block.x)],
    source="src/repro_torch/csrc/stencil1d.cu")


def stencil2d_plain(b, grid: Dim3, block: Dim3, *, h: int, w: int):
    """``y = 0.2 (c + n + s + w + e)``, summed left to right with the reads
    clamped, over the cells the grid covers."""
    x = b["x"]
    nr, nc = min(h, grid.y * block.y), min(w, grid.x * block.x)
    r = torch.arange(nr, device=x.device)[:, None]
    c = torch.arange(nc, device=x.device)[None, :]

    def at(rr, cc):
        return x[rr.clamp(0, h - 1), cc.clamp(0, w - 1)]

    y = b["y"].clone()
    y[:nr, :nc] = 0.2 * (x[:nr, :nc] + at(r - 1, c) + at(r + 1, c)
                         + at(r, c - 1) + at(r, c + 1))
    return {"y": y}


def stencil2d_region() -> tuple[int, int]:
    """The rows and columns of cells one CTA of ``csrc/stencil2d.cu``
    covers, as its ``stencil2d_cta_rows`` / ``stencil2d_cta_cols`` give
    them (builds the kernels' library at first use)."""
    return (_native.function("stencil2d_cta_rows", ())(),
            _native.function("stencil2d_cta_cols", ())())


def stencil2d_ctas(h: int, w: int, grid) -> tuple[int, int]:
    """The physical grid ``(x, y)`` of :func:`stencil2d_region` CTAs that
    covers the cells a logical ``grid`` of 8 x 8 tiles writes in an ``[h,
    w]`` array."""
    return tile_grid_ctas(h, w, grid, stencil2d_region(), STENCIL2D_TILE)


STENCIL2D = CudaKernel(
    name="stencil2d", symbol="launch_stencil2d",
    argtypes=(_P,) * 2 + (_I,) * 6 + (_P,),
    buffers={"x": _F32, "y": _F32},
    writes=("y",),
    shapes=lambda *, h, w: {"x": (h, w), "y": (h, w)},
    check=_tile_2d("stencil2d", STENCIL2D_TILE), plain=stencil2d_plain,
    cargs=lambda b, grid, block, *, h, w: [
        _ptr(b["x"]), _ptr(b["y"]), h, w, grid.x, grid.y,
        *stencil2d_ctas(h, w, grid)],
    source="src/repro_torch/csrc/stencil2d.cu")


# --------------------------------------------------------------------------
# softmax_row
# --------------------------------------------------------------------------
def softmax_row_plain(b, grid: Dim3, block: Dim3, *, rows: int,
                      nthreads: int):
    """``exp(x - max) / sum(exp(x - max))`` of each row the grid covers."""
    x = b["x"][:grid.x]
    e = torch.exp(x - x.amax(1, keepdim=True))
    y = b["y"].clone()
    y[:grid.x] = e / e.sum(1, keepdim=True)
    return {"y": y}


def _softmax_row_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("softmax_row")(grid, block, params)
    _block_of("softmax_row", block, params["nthreads"])
    if block.x % 32:
        raise UnsupportedKernel(f"softmax_row: the max and the sum run per "
                                f"full warp; block {block.x} is not a "
                                f"multiple of 32")
    if grid.x > params["rows"]:
        raise UnsupportedKernel(f"softmax_row: grid {grid.x} exceeds the "
                                f"{params['rows']} rows")


SOFTMAX_ROW = CudaKernel(
    name="softmax_row", symbol="launch_softmax_row",
    argtypes=(_P,) * 2 + (_I,) * 2 + (_P,),
    buffers={"x": _F32, "y": _F32},
    writes=("y",),
    shapes=lambda *, rows, nthreads: {"x": (rows, nthreads),
                                      "y": (rows, nthreads)},
    check=_softmax_row_check, plain=softmax_row_plain,
    cargs=lambda b, grid, block, *, rows, nthreads: [
        _ptr(b["x"]), _ptr(b["y"]), grid.x, block.x],
    source="src/repro_torch/csrc/softmax_row.cu")


# --------------------------------------------------------------------------
# scan_block
# --------------------------------------------------------------------------
def scan_block_plain(b, grid: Dim3, block: Dim3, *, n: int, nthreads: int):
    """The inclusive prefix sum of each block's ``x``, level by level as
    the Hillis-Steele kernel adds (``s[t] += s[t - d]``, or ``+ 0.0`` for
    ``t < d``, for ``d`` = 1, 2, 4, ...)."""
    m = grid.x * block.x
    v = b["x"][:m].view(grid.x, block.x)
    d = 1
    while d < block.x:
        add = torch.zeros_like(v)
        add[:, d:] = v[:, :-d]
        v = v + add
        d *= 2
    y = b["y"].clone()
    y[:m] = v.reshape(-1)
    return {"y": y}


def _scan_block_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("scan_block")(grid, block, params)
    _pow2_block("scan_block", block, params["nthreads"])
    _within("scan_block", grid, block, params["n"])


SCAN_BLOCK = CudaKernel(
    name="scan_block", symbol="launch_scan_block",
    argtypes=(_P,) * 2 + (_I,) * 2 + (_P,),
    buffers={"x": _F32, "y": _F32},
    writes=("y",),
    shapes=lambda *, n, nthreads: {"x": (n,), "y": (n,)},
    check=_scan_block_check, plain=scan_block_plain,
    cargs=lambda b, grid, block, *, n, nthreads: [
        _ptr(b["x"]), _ptr(b["y"]), grid.x, block.x],
    source="src/repro_torch/csrc/scan_block.cu")


# --------------------------------------------------------------------------
# transpose_tiled
# --------------------------------------------------------------------------
TRANSPOSE_TILE = 8


def transpose_tiled_plain(b, grid: Dim3, block: Dim3, *, h: int, w: int):
    """``y[c, r] = x[r, c]`` for the 8 x 8 tiles the grid covers (tile
    ``by * w/8 + bx``)."""
    x, t = b["x"], TRANSPOSE_TILE
    r = torch.arange(h, device=x.device)[:, None] // t
    c = torch.arange(w, device=x.device)[None, :] // t
    covered = r * (w // t) + c < grid.x
    return {"y": torch.where(covered.t(), x.t(), b["y"])}


def _transpose_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("transpose_tiled")(grid, block, params)
    h, w, t = params["h"], params["w"], TRANSPOSE_TILE
    if block.x != t * t:
        raise UnsupportedKernel(f"transpose_tiled: one thread per element of "
                                f"a {t}x{t} tile; got block {block.x}")
    if h % t or w % t:
        raise UnsupportedKernel(f"transpose_tiled: h, w = {h}, {w} are not "
                                f"multiples of {t}")
    if grid.x > (h // t) * (w // t):
        raise UnsupportedKernel(f"transpose_tiled: grid {grid.x} exceeds the "
                                f"{(h // t) * (w // t)} tiles")


def transpose_tiled_side() -> int:
    """The side of the square of x that one physical CTA of
    ``csrc/transpose_tiled.cu`` moves, as its ``transpose_tiled_side``
    gives it (builds the kernels' library at first use)."""
    return _native.function("transpose_tiled_side", ())()


def transpose_tiled_ctas(h: int, w: int, grid: int) -> tuple[int, int]:
    """The physical grid ``(x, y)`` of :func:`transpose_tiled_side`-square
    CTAs that covers a logical grid of ``grid`` 8 x 8 tiles of an ``[h,
    w]`` x (tile ``by * w/8 + bx``): the CTA columns down to the last
    column the grid reaches, and the CTA rows down to its last tile row."""
    t, per_row = TRANSPOSE_TILE, w // TRANSPOSE_TILE
    cols = min(grid, per_row) * t
    rows = -(-grid // per_row) * t
    side = transpose_tiled_side()
    return -(-cols // side), -(-rows // side)


TRANSPOSE_TILED = CudaKernel(
    name="transpose_tiled", symbol="launch_transpose_tiled",
    argtypes=(_P,) * 2 + (_I,) * 5 + (_P,),
    buffers={"x": _F32, "y": _F32},
    writes=("y",),
    shapes=lambda *, h, w: {"x": (h, w), "y": (w, h)},
    check=_transpose_check, plain=transpose_tiled_plain,
    cargs=lambda b, grid, block, *, h, w: [
        _ptr(b["x"]), _ptr(b["y"]), h, w, grid.x,
        *transpose_tiled_ctas(h, w, grid.x)],
    source="src/repro_torch/csrc/transpose_tiled.cu")


# --------------------------------------------------------------------------
# pixel_pipeline
# --------------------------------------------------------------------------
def pixel_pipeline_plain(b, grid: Dim3, block: Dim3, *, n: int,
                         nthreads: int, c0: float, c1: float):
    """``out = exp(log(img) * c0 + c1)`` for the pixels the grid covers."""
    m = grid.x * block.x
    out = b["out"].clone()
    out[:m] = torch.exp(torch.log(b["img"][:m]) * c0 + c1)
    return {"out": out}


def _pixel_pipeline_check(grid: Dim3, block: Dim3, params: dict):
    _one_dim("pixel_pipeline")(grid, block, params)
    _block_of("pixel_pipeline", block, params["nthreads"])
    _within("pixel_pipeline", grid, block, params["n"])


def pixel_pipeline_cta_elems() -> int:
    """The elements one CTA of ``csrc/pixel_pipeline.cu`` covers, as its
    ``pixel_pipeline_cta_elems`` gives them (builds the kernels' library
    at first use)."""
    return _native.function("pixel_pipeline_cta_elems", ())()


def pixel_pipeline_ctas(n: int, grid: int, block: int) -> int:
    """The CTAs of :func:`pixel_pipeline_cta_elems` elements that cover
    the ``m = min(n, grid * block)`` elements a logical grid writes."""
    return -(-min(n, grid * block) // pixel_pipeline_cta_elems())


PIXEL_PIPELINE = CudaKernel(
    name="pixel_pipeline", symbol="launch_pixel_pipeline",
    argtypes=(_P,) * 2 + (_F,) * 2 + (_I,) * 3 + (_P,),
    buffers={"img": _F32, "out": _F32},
    writes=("out",),
    shapes=lambda *, n, nthreads, c0, c1: {"img": (n,), "out": (n,)},
    check=_pixel_pipeline_check, plain=pixel_pipeline_plain,
    cargs=lambda b, grid, block, *, n, nthreads, c0, c1: [
        _ptr(b["img"]), _ptr(b["out"]), c0, c1, grid.x, block.x,
        pixel_pipeline_ctas(n, grid.x, block.x)],
    source="src/repro_torch/csrc/pixel_pipeline.cu")


KERNELS: dict[str, CudaKernel] = {
    k.name: k for k in (BFS_FRONTIER, PATHFINDER, NEEDLE_NW, HOTSPOT,
                        SRAD_STATS, SRAD_UPDATE, NN_REDUCE, NN_SELECT,
                        KMEANS_ASSIGN, KMEANS_UPDATE, BACKPROP_LAYER,
                        LUD_DIAG, LAVAMD, STREAMCLUSTER, VECADD, REVERSE,
                        HISTOGRAM_COALESCED, HISTOGRAM_CONTIGUOUS,
                        REDUCE_SHARED, REDUCE_WARP, MATMUL_TILED,
                        STENCIL1D, STENCIL2D, SOFTMAX_ROW, SCAN_BLOCK,
                        TRANSPOSE_TILED, PIXEL_PIPELINE)}


def kernel_for(kernel: KernelDef) -> CudaKernel:
    """The wrapper of ``kernel``'s hand-written body, or raise."""
    if kernel.native is None:
        raise UnsupportedKernel(
            f"kernel {kernel.name}: no hand-written CUDA body (the cuda "
            f"backend launches native kernels only)")
    try:
        return KERNELS[kernel.native.symbol]
    except KeyError:
        raise UnsupportedKernel(
            f"kernel {kernel.name}: unknown native symbol "
            f"{kernel.native.symbol!r}; have {sorted(KERNELS)}") from None


def check(kernel: KernelDef, block) -> None:
    """Raise :class:`UnsupportedKernel` unless ``kernel`` has a body here."""
    kernel_for(kernel)


def launch_params(kernel: KernelDef, dyn_shared=None) -> dict:
    """The wrapper's keyword parameters for one launch of ``kernel``: its
    native scalars, plus the launch's ``dyn_shared`` slot (in elements)
    for a kernel with an extern ``__shared__`` array."""
    params = dict(kernel.native.params)
    if kernel_for(kernel).extern is not None:
        params["dyn_shared"] = dyn_shared
    return params


def prepare_capture(kernel: KernelDef, glob: dict, dyn_shared=None) -> None:
    """Allocate the scratch that a launch of ``kernel`` over ``glob`` on
    the current stream takes, outside any capture: a capture on that
    stream then finds it.  bfs_frontier's ``owner`` is filled once per
    stream and must outlive the graph, not come from its memory pool.
    A kernel whose buffers the graph itself creates is left alone."""
    k = kernel_for(kernel)
    if set(k.buffers) <= set(glob):
        k.scratch({n: glob[n] for n in k.buffers},
                  **launch_params(kernel, dyn_shared))


def run(kernel: KernelDef, *, grid, block, glob, grain=1, dyn_shared=None,
        interpret=True) -> dict:
    outs = kernel_for(kernel)(glob, grid=grid, block=block,
                              **launch_params(kernel, dyn_shared))
    return {**glob, **outs}
