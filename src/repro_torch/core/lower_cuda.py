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

Launches are functional, like the reference's: the written buffers are
copied, the copies updated, and the inputs left untouched.  ``grain`` and
``interpret`` are accepted for the uniform backend signature and have no
effect: the card's block scheduler does the fetching.
"""
from __future__ import annotations

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


def _no_scratch(bufs, **params) -> dict:
    return {}


@dataclasses.dataclass
class CudaKernel:
    """One hand-written kernel: validation, routing, and its launch count.

    ``buffers`` maps each bound buffer to its dtype; ``shapes`` gives the
    expected shape of each from the scalar parameters; ``check`` validates
    the launch geometry; ``scratch`` allocates the device scratch a launch
    needs; ``cargs`` lists the C launcher's arguments (without the
    trailing stream) for buffers on the card.
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
        fn = _native.function(self.symbol, self.argtypes)
        device = next(iter(bufs.values())).device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*self.cargs(work, grid, block, **params), stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: launch failed with "
                               f"cudaError_t {rc}")
        self.launches += 1


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _one_dim(name):
    def check(grid: Dim3, block: Dim3, params: dict):
        if grid.y * grid.z != 1 or block.y * block.z != 1:
            raise UnsupportedKernel(f"{name}: 1-D grid and block expected, "
                                    f"got {grid} x {block}")
    return check


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


BFS_FRONTIER = CudaKernel(
    name="bfs_frontier", symbol="launch_bfs_frontier",
    argtypes=(_P,) * 8 + (_I,) * 4 + (_P,),
    buffers={"edges": _I32, "frontier": _I32, "visited": _I32, "nxt": _I32,
             "dist": _I32, "active": _I32, "level": _I32},
    writes=("visited", "nxt", "dist", "active"),
    shapes=_bfs_shapes, check=_bfs_check, plain=bfs_frontier_plain,
    scratch=lambda b, *, n, deg: {"owner": torch.full(
        (n,), _INT_MAX, dtype=_I32, device=b["edges"].device)},
    cargs=lambda b, grid, block, *, n, deg: [
        _ptr(b["edges"]), _ptr(b["frontier"]), _ptr(b["owner"]),
        _ptr(b["visited"]), _ptr(b["nxt"]), _ptr(b["dist"]),
        _ptr(b["active"]), _ptr(b["level"]), n, deg, grid.x, block.x],
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
        raise UnsupportedKernel(f"pathfinder: the kernel's shared halo is "
                                f"sized for {PATHFINDER_BLOCK}-thread "
                                f"blocks, got {block.x}")


PATHFINDER = CudaKernel(
    name="pathfinder", symbol="launch_pathfinder",
    argtypes=(_P,) * 4 + (_I,) * 3 + (_P,),
    buffers={"wall": _I32, "src": _I32, "dst": _I32, "row": _I32},
    writes=("dst",),
    shapes=lambda *, cols: {"src": (cols,), "dst": (cols,), "row": (1,)},
    check=_pathfinder_check, plain=pathfinder_plain,
    cargs=lambda b, grid, block, *, cols: [
        _ptr(b["wall"]), _ptr(b["src"]), _ptr(b["dst"]), _ptr(b["row"]),
        b["wall"].shape[0], cols, grid.x],
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


NEEDLE_NW = CudaKernel(
    name="needle_nw", symbol="launch_needle_nw",
    argtypes=(_P,) * 3 + (_I,) * 4 + (_P,),
    buffers={"score": _I32, "sim": _I32, "diag": _I32},
    writes=("score",),
    shapes=lambda *, n, penalty: {"score": (n + 1, n + 1), "sim": (n, n),
                                  "diag": (1,)},
    check=_one_dim("needle_nw"), plain=needle_nw_plain,
    cargs=lambda b, grid, block, *, n, penalty: [
        _ptr(b["score"]), _ptr(b["sim"]), _ptr(b["diag"]), n, penalty,
        grid.x, block.x],
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


def _hotspot_check(grid: Dim3, block: Dim3, params: dict):
    if block != Dim3(HOTSPOT_TILE, HOTSPOT_TILE) or grid.z != 1:
        raise UnsupportedKernel(f"hotspot: the kernel's shared tile is "
                                f"{HOTSPOT_TILE}x{HOTSPOT_TILE} over a 2-D "
                                f"grid; got {grid} x {block}")


HOTSPOT = CudaKernel(
    name="hotspot", symbol="launch_hotspot",
    argtypes=(_P,) * 3 + (_I,) * 2 + (_F,) * 5 + (_I,) * 2 + (_P,),
    buffers={"t": _F32, "p": _F32, "t_out": _F32},
    writes=("t_out",),
    shapes=lambda *, h, w, **_: {"t": (h, w), "p": (h, w), "t_out": (h, w)},
    check=_hotspot_check, plain=hotspot_plain,
    cargs=lambda b, grid, block, *, h, w, cap, rx, ry, rz, amb: [
        _ptr(b["t"]), _ptr(b["p"]), _ptr(b["t_out"]), h, w, cap, rx, ry, rz,
        amb, grid.x, grid.y],
    source="src/repro_torch/csrc/hotspot.cu")


KERNELS: dict[str, CudaKernel] = {
    k.name: k for k in (BFS_FRONTIER, PATHFINDER, NEEDLE_NW, HOTSPOT)}


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


def run(kernel: KernelDef, *, grid, block, glob, grain=1, dyn_shared=None,
        interpret=True) -> dict:
    outs = kernel_for(kernel)(glob, grid=grid, block=block,
                              **dict(kernel.native.params))
    return {**glob, **outs}
