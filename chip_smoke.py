#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the ``nvcc`` build
   of ``src/repro_torch/csrc/*.cu`` into ``build/repro_torch/``;
2. per hand-written kernel (26 for the 23 entries: srad_step, nn and
   kmeans run two kernels an iteration): one launch at the main path's
   shape through the kernel and through its plain PyTorch version on the same
   inputs on the card, compared (within the entry's ``tol`` for the
   float32 results of the ``TOLERANT`` kernels, bit for bit for every
   other kernel), then both timed with CUDA events, the median of 25 runs
   after warm-up.  A chain's first kernel runs on the entry's inputs, a later
   one on the state that one launch of each kernel before it leaves.
   ``ms`` is the kernel alone (its written buffers restored between runs,
   outside the timed window); ``call_ms`` adds the wrapper's functional
   copy of the written buffers; ``bound_ms`` is the least time the card
   could take for the launch's bytes and operations; ``library_ms`` times
   the one PyTorch call that computes the same function, where there is
   one (lud's unpivoted ``torch.linalg.lu_factor``; the per-block sums of
   ``x`` for the two reductions, and for srad_stats, where the call gives
   ``psum`` alone but reads the same bytes as the kernel; the per-block
   ``torch.min`` of the distances for nn_reduce, when its indices agree;
   ``torch.add``, ``torch.flip``, ``torch.bincount`` and ``torch.matmul``
   for vecadd, reverse, histogram and matmul_tiled; ``torch.softmax``,
   the per-block ``torch.cumsum`` and ``x.t().contiguous()`` for
   softmax_row, scan_block and transpose_tiled).  Float32 matrix
   products run in full float32: TF32 is switched off explicitly, or
   matmul_tiled's plain version and yardstick would compute something
   else.  The lines of matmul_tiled, of vecadd (CTAs of 256 threads that
   move two float4s each) and of the kernels that run a logical block a
   warp in CTAs of 256 (reduce_shared, reduce_warp, srad_stats,
   softmax_row: one row a warp, its values in registers, no barrier)
   also give their physical CTA counts, as do transpose_tiled's (64 x
   64 squares of x, one barrier each, from
   ``lower_cuda.transpose_tiled_ctas``), hotspot's (8 warps a CTA over
   8 x 128 cells, ``lower_cuda.hotspot_ctas``) and bfs_frontier's (1024
   nodes a CTA of 256 in each of its two passes,
   ``lower_cuda.bfs_frontier_ctas``).  bfs_frontier's line also gives
   ``levels_ms``, its kernel time summed over the chain's launches, each
   timed at the state its level sees, and ``levels_bound_ms``, their
   bounds summed; the ``levels bfs_frontier`` line before it has each
   level's time, bound and frontier;
3. the main path: the eleven Rodinia entries at Rodinia 3.1's run-script
   sizes, and the twelve textbook entries at sizes that load the card
   (``SIZES``), through ``run_entry(entry, backend="cuda")`` - chevron/
   api/backends/``lower_cuda`` - with every launch count set to 0 just before
   and read just after; each kernel of the entry must have launched, and
   their launches must sum to the chain's count.  Each entry is checked
   against the port's NumPy oracle (timed, since lavaMD's runs 27,000
   NumPy steps): integer buffers and all of kmeans's bit for bit, the
   other float32 ones within the entry's ``tol`` (``EXACT_ENTRIES`` bit
   for bit).  Seven entries are launch chains and sixteen single
   launches.  Every entry draws its inputs from one generator seeded
   with ``SEED``, in the order of ``SIZES``.
   Then needle_nw's host time per launch, layer by layer;
4. the hot-path kernels (matmul, rmsnorm, flash attention) at
   granite-3-2b's widths (``HOT``): each call goes through
   ``repro_torch.kernels.ops.<fn>`` with tensors on the card and
   ``mode=None``, in bfloat16 and in float32, with every launch count set
   to 0 just before and read just after.  matmul and flash attention
   choose one of their kernels by ``route``; ``HOT_KERNELS`` says which
   kernel each call and dtype must take (bfloat16 matmul and prefill the
   tensor-core kernels, decode the split-kv kernel in both dtypes,
   float32 matmul and prefill the CUDA-core kernels), and that kernel must
   launch exactly once, no other.  The CUDA-core matmul's line gives its
   CTA count (one a 128 x 128 tile of c, fed by 16-byte loads issued a
   slice ahead into two shared buffers), rmsnorm's its (8 rows a CTA,
   a row in a warp's registers), and the CUDA-core prefill's its CTA
   count and query tile (256 queries a CTA at d = 64, register outer
   products, the next K/V tile in flight by cp.async).  Each output is
   held against that kernel's plain version (flash attention at
   ``flash_attention.PLAIN_TOL``, the others at ``hot_tol``) and the
   ``ref`` oracle (``hot_tol``) on the card, then kernel, plain version
   and the PyTorch yardstick
   (``F.rms_norm``, ``torch.matmul``, ``F.scaled_dot_product_attention``,
   timed only) are timed as in phase 2.  The inputs are drawn from the
   same generator after every entry's;
5. the kernels' JSON line (the 26 suite kernels and a row per hot-path
   call and dtype, named ``<kernel>/<call>/<dtype>``), the card line, and
   last
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line,
as it does with no CUDA device or outside a checkout of the repository.
It imports neither JAX nor the reference package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 42
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
#: H100 SXM exp2/rcp/rsqrt results on the special-function units: 16 per
#: clock per SM (CUDA C++ Programming Guide, arithmetic-instruction
#: throughput, compute capability 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
REPLACES = "src/repro/core/pallas_emit.py:34"
#: float32 kernels held to the entry's tol against their plain versions
#: (FMA contraction, exp, a fold in another order); every other kernel is
#: held bit for bit
TOLERANT = ("srad_update", "backprop_layer", "lud_diag", "lavamd",
            "matmul_tiled", "softmax_row", "pixel_pipeline")
#: entries whose float32 results the oracle fixes bit for bit
EXACT_ENTRIES = ("kmeans", "vecadd", "stencil1d", "stencil2d",
                 "transpose_tiled")
BF16_OPS_PER_S = 989e12          # H100 SXM dense bfloat16 tensor cores
SLEEP_CYCLES = 1_000_000         # keeps the card busy while a run enqueues
RUNS, WARMUP = 25, 3

#: Rodinia 3.1 run-script sizes, then the textbook entries at sizes that
#: move tens of MB (inputs generated from SEED)
SIZES = {
    "bfs_frontier": {"n": 1_000_000, "deg": 6},          # graph1MW_6
    "pathfinder": {"cols": 100_000, "rows": 100},        # 100000 100 20
    "needle_nw": {"n": 2048, "penalty": 10},             # needle 2048 10
    "hotspot": {"h": 1024, "w": 1024, "iters": 20},      # temp_1024
    # backprop 65536: 16 hidden units, ETA 0.3
    "backprop_layer": {"in_n": 65536, "out_n": 16, "lr": 0.3},
    "lud_diag": {"ntiles": 128, "b": 16},   # 2048.dat's 16x16 diagonal tiles
    # lavaMD -boxes1d 10: 1000 boxes of 100 particles, home + 26 neighbours
    "lavamd": {"nboxes": 1000, "ppb": 100, "nnei": 27, "alpha": 0.5},
    # sc_gpu 10 20 256 65536 65536 ...: 65,536 points, kmax 20
    "streamcluster": {"n": 65536, "k": 20, "block": 64},
    # the two-kernel chains come last, so that the entries above draw the
    # same inputs from the one generator as they did before these three
    # srad_v2: srad 2048 2048 0 127 0 127 0.5 2
    "srad_step": {"h": 2048, "w": 2048, "iters": 2, "lam": 0.5},
    # nn filelist_4 -r 5 -lat 30 -lng 90 (42,764 records, raised to the
    # 256 x 256 that the one-block select takes)
    "nn": {"n": 65536, "block": 256, "knn": 5},
    # kmeans -o -i kdd_cup (494,020 points, 7,720 whole blocks of 64)
    "kmeans": {"n": 494080, "k": 4, "block": 64, "repeat": 12},
    # the textbook entries come after the Rodinia ones, for the same
    # reason; none has a run script
    "vecadd": {"n": 1 << 24, "block": 128},              # 201 MB moved
    "reverse": {"n": 1024},             # CUDA's widest block, 1024 ints
    # 2^24 8-bit pixels in int32, 1024 x 256 threads of 64 pixels each
    "histogram": {"n": 1 << 24, "nbins": 256, "grid": 1024, "block": 256},
    "reduce_shared": {"n": 1 << 24, "block": 256},       # 65,536 sums
    "reduce_warp": {"n": 1 << 24, "block": 256},
    "matmul_tiled": {"m": 2048, "n": 2048, "k": 2048},   # 65,536 tiles
    # the last six, each 2^24 float32 in and out (134 MB moved)
    "stencil1d": {"n": 1 << 24, "block": 128},           # 131,072 blocks
    "stencil2d": {"h": 4096, "w": 4096},                 # grid (512, 512)
    "softmax_row": {"rows": 131_072, "block": 128},      # a block a row
    "scan_block": {"n": 1 << 24, "block": 128},
    "transpose_tiled": {"h": 4096, "w": 4096},           # 262,144 tiles
    "pixel_pipeline": {"n": 1 << 24, "block": 128},
}


#: the hot-path calls at granite-3-2b's widths
#: (src/repro/configs/granite_3_2b.py: d_model 2048, 32 heads of 64, 8 kv
#: heads, d_ff 8192), over two sequences of train_4k's 4096 tokens
#: (src/repro/configs/registry.py:59); decode as attend_decode, one new
#: token for each of 32 sequences over a 4096-token cache
HOT = {
    "rmsnorm": {"rows": 2 * 4096, "d": 2048},
    "matmul": {"m": 2 * 4096, "k": 2048, "n": 8192},   # the MLP's up proj
    "flash_attention_prefill": {"b": 2, "h": 32, "hkv": 8, "sq": 4096,
                                "skv": 4096, "d": 64, "causal": True},
    "flash_attention_decode": {"b": 32, "h": 32, "hkv": 8, "sq": 1,
                               "skv": 4096, "d": 64, "causal": False},
}
HOT_REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm.py:17",
                "matmul": "src/repro/kernels/matmul.py:21",
                "flash_attention": "src/repro/kernels/flash_attention.py:34"}
HOT_DTYPES = (torch.bfloat16, torch.float32)
#: the kernel (``ops.KERNELS`` name) each hot-path call must launch
HOT_KERNELS = {
    ("rmsnorm", torch.bfloat16): "rmsnorm",
    ("rmsnorm", torch.float32): "rmsnorm",
    ("matmul", torch.bfloat16): "matmul_tc",
    ("matmul", torch.float32): "matmul",
    ("flash_attention_prefill", torch.bfloat16): "flash_attention_tc",
    ("flash_attention_prefill", torch.float32): "flash_attention",
    ("flash_attention_decode", torch.bfloat16): "flash_decode",
    ("flash_attention_decode", torch.float32): "flash_decode",
}
def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, before=None) -> float:
    """Median CUDA-event time of ``fn()`` in ms over ``RUNS`` runs.

    ``before()`` runs ahead of each run, outside the timed window; a spin
    on the card then covers the host's enqueue of the run, so the window
    holds the device's work and not the host's."""
    times = []
    for i in range(WARMUP + RUNS):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= WARMUP:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def entries(cuda_suite):
    return {name: getattr(cuda_suite, f"entry_{name}")(**size)
            for name, size in SIZES.items()}


def bfs_state(args: dict, dist: np.ndarray, level: int) -> dict:
    """bfs's buffers before the chain's launch at ``level``: the state
    before a level's expansion is fixed by the distances alone."""
    return {**args, "frontier": (dist == level).astype(np.int32),
            "visited": ((dist >= 0) & (dist <= level)).astype(np.int32),
            "dist": np.where(dist <= level, dist, -1).astype(np.int32),
            "level": np.full(1, level, np.int32)}


def launch_inputs(name: str, args: dict, cuda_suite, dev) -> dict:
    """The buffers of an entry's first launch on the card, at a state the
    main path reaches.

    BFS takes the level with the widest frontier; nw its longest
    diagonal; the other chains their first launch; the single-launch
    entries their one launch.
    """
    args = dict(args)
    if name == "bfs_frontier":
        dist = cuda_suite.bfs_levels(args["edges"], SIZES[name]["n"])
        args = bfs_state(args, dist, int(np.bincount(dist[dist >= 0])
                                         .argmax()))
    elif name == "needle_nw":
        args["diag"] = np.full(1, SIZES[name]["n"] + 1, np.int32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in args.items()}


def bound(name: str, b: dict, p: dict, grid, block) -> tuple[float, str]:
    """Least time (ms) the card could take for one launch: every byte the
    launch needs read once and every byte it writes written once, over
    the memory rate, against its operations over the peak rate of the
    unit that does them (float32 lanes; special-function units for exp).
    Integer work is not counted: it is far below the bytes' time."""
    i4, ops_ms = 4, 0.0
    if name == "bfs_frontier":
        n = p["n"]
        front = b["frontier"] == 1
        nbr = b["edges"][front].reshape(-1)
        nbr = torch.unique(nbr[(nbr >= 0) & (nbr < n)])
        claims = int((b["visited"][nbr] == 0).sum())
        # frontier flags and level; the frontier's edge rows; the flags of
        # the neighbours they reach; visited, nxt, dist of each claimed
        # node; active read and written
        nbytes = i4 * (n + 1 + int(front.sum()) * p["deg"] + nbr.numel()
                       + 3 * claims + 2)
    elif name == "pathfinder":
        nbytes = i4 * (3 * p["cols"] + 1)   # wall row, src, row; dst
    elif name == "needle_nw":
        n, d = p["n"], int(b["diag"][0])
        cells = min(n, d - 1) - max(1, d - n) + 1
        # the two previous diagonals, the sim diagonal, the written one
        nbytes = i4 * (4 * cells + 2)
    elif name == "hotspot":
        cells = p["h"] * p["w"]
        nbytes = i4 * 3 * cells                 # t, p in; t_out out
        ops_ms = 15.0 * cells / F32_OPS_PER_S * 1e3   # flops per cell
    elif name == "srad_stats":
        npix = p["h"] * p["w"]
        nbytes = i4 * (npix + 2 * grid.x)        # x in; psum, psq out
        ops_ms = 3.0 * npix / F32_OPS_PER_S * 1e3     # square, two adds
    elif name == "srad_update":
        npix = p["h"] * p["w"]
        # x and the partials in; y out
        nbytes = i4 * (2 * npix + b["psum"].numel() + b["psq"].numel())
        # about 30 float operations per pixel, four of them divisions
        ops_ms = 30.0 * npix / F32_OPS_PER_S * 1e3
    elif name == "nn_reduce":
        # lat, lng, taken, target in; pval, pidx out
        nbytes = i4 * (3 * p["n"] + 2 + 2 * grid.x)
    elif name == "nn_select":
        # pval, pidx, step in; out_d, out_i, one taken flag out
        nbytes = i4 * (2 * block.x + 1 + 3)
    elif name == "kmeans_assign":
        n, k = p["n"], p["k"]
        # px, py, assign in, assign out; the centroids; sums, counts and
        # changed read and written
        nbytes = i4 * (4 * n + 2 * k + 2 * (3 * k + 1))
        ops_ms = 5.0 * n * k / F32_OPS_PER_S * 1e3    # a distance per pair
    elif name == "kmeans_update":
        nbytes = i4 * 7 * p["k"]                 # sums, count, cx, cy; cx, cy
    elif name == "backprop_layer":
        weights = p["out_n"] * p["in_n"]
        # inp, w, bias, delta in; hidden, w_out out
        nbytes = i4 * (p["in_n"] + 2 * weights + 3 * p["out_n"])
        # product and sum; lr*delta*inp and its add
        ops_ms = 4.0 * weights / F32_OPS_PER_S * 1e3
    elif name == "lud_diag":
        tiles, tile = grid.x, p["b"]
        nbytes = i4 * 2 * tiles * tile * tile   # a in; lu out
        # step k: a division and a product-difference per element, for
        # each of the tile - 1 - k rows below the pivot
        flops = sum((tile - 1 - k) * (1 + 2 * (tile - 1 - k))
                    for k in range(tile - 1))
        ops_ms = tiles * flops / F32_OPS_PER_S * 1e3
    elif name == "lavamd":
        boxes, ppb = grid.x, p["ppb"]
        n = boxes * ppb
        nbytes = i4 * (3 * n + boxes * p["nnei"])   # pos, q, nbr; force
        pairs = float(boxes * p["nnei"] * ppb * ppb)
        # per pair: subtract, two products, the charge product, the add;
        # and one exp on the special-function units
        ops_ms = max(5.0 * pairs / F32_OPS_PER_S,
                     pairs / SFU_OPS_PER_S) * 1e3
    elif name == "vecadd":
        nbytes = i4 * 3 * p["n"]                # a, b in; c out
        ops_ms = p["n"] / F32_OPS_PER_S * 1e3
    elif name == "reverse":
        nbytes = i4 * 2 * block.x               # d in and out
    elif name == "histogram_coalesced":
        nbytes = i4 * (p["n"] + 2 * p["nbins"])   # x in; hist in and out
    elif name in ("reduce_shared", "reduce_warp"):
        nbytes = i4 * (p["n"] + grid.x)         # x in; a sum a block out
        ops_ms = p["n"] / F32_OPS_PER_S * 1e3
    elif name == "matmul_tiled":
        m, n, k = p["m"], p["n"], p["k"]
        nbytes = i4 * (m * k + k * n + m * n)   # a, b in; c out
        ops_ms = 2.0 * m * n * k / F32_OPS_PER_S * 1e3
    elif name in ("stencil1d", "stencil2d"):
        cells = p["n"] if name == "stencil1d" else p["h"] * p["w"]
        nbytes = i4 * 2 * cells                 # x in; y out
        ops_ms = 5.0 * cells / F32_OPS_PER_S * 1e3   # the sum and scaling
    elif name == "softmax_row":
        cells = p["rows"] * p["nthreads"]
        nbytes = i4 * 2 * cells                 # x in; y out
        ops_ms = cells / SFU_OPS_PER_S * 1e3    # one exp a value
    elif name == "scan_block":
        nbytes = i4 * 2 * p["n"]                # x in; y out
        levels = p["nthreads"].bit_length() - 1
        ops_ms = levels * p["n"] / F32_OPS_PER_S * 1e3
    elif name == "transpose_tiled":
        nbytes = i4 * 2 * p["h"] * p["w"]       # x in; y out
    elif name == "pixel_pipeline":
        nbytes = i4 * 2 * p["n"]                # img in; out out
        ops_ms = 2.0 * p["n"] / SFU_OPS_PER_S * 1e3  # a log and an exp
    else:                                       # streamcluster
        m, k = p["n"], p["k"]
        cand = b["cand"].long()
        dcur = ((b["px"] - b["cx"][b["assign"].long()]) ** 2
                + (b["py"] - b["cy"][b["assign"].long()]) ** 2)
        dcand = (b["px"] - cand[0]) ** 2 + (b["py"] - cand[1]) ** 2
        switchers = int((dcand < dcur).sum())
        # px, py, assign, cx, cy, cand in; each switcher's flag, gain,
        # csave, dirty, ndirty out
        nbytes = i4 * (3 * m + 2 * k + 2 + switchers + 2 + 2 * k)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def compare(name: str, got: dict, want: dict, writes, tol: float) -> float:
    """Max abs error of the kernel against its plain version; raises when
    they disagree (``tol`` for the float32 results of the ``TOLERANT``
    kernels, exact otherwise)."""
    err = 0.0
    for k in writes:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {k} is {g.dtype}{tuple(g.shape)}"
                                 f", plain gives {w.dtype}{tuple(w.shape)}")
        if g.dtype == torch.float32 and name in TOLERANT:
            if not (torch.isfinite(g).all()
                    and torch.allclose(g, w, rtol=tol, atol=tol)):
                raise AssertionError(f"{name}: {k} disagrees with plain")
        elif not torch.equal(g, w):
            raise AssertionError(f"{name}: {k} differs from plain")
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


#: kernels whose launcher runs a logical block a warp, in CTAs of 256
WARP_BLOCK_KERNELS = ("reduce_shared", "reduce_warp", "srad_stats",
                      "softmax_row")


def warp_block_ctas(grid: int, block: int) -> int:
    """The physical CTAs of 256 threads that a ``WARP_BLOCK_KERNELS``
    launcher starts for ``grid`` logical blocks of ``block`` threads: a
    warp a block, or 32/block blocks a warp below 32 threads."""
    warps = -(-grid * min(block, 32) // 32)
    return -(-warps // 8)


def library_call(name: str, b: dict, params: dict, grid, block, got):
    """The one PyTorch call that computes the kernel's function, or None.

    Timed beside the kernel as a yardstick; the port never calls it.
    srad_stats's call gives ``psum`` alone; nn_reduce's takes the
    distances as its input and counts only where its indices are the
    kernel's."""
    if name == "vecadd":
        xa, xb = b["a"], b["b"]
        return lambda: torch.add(xa, xb)
    if name == "reverse":
        d = b["d"]
        return lambda: torch.flip(d, (0,))
    if name == "histogram_coalesced":
        x, nbins = b["x"], params["nbins"]
        return lambda: torch.bincount(x, minlength=nbins).to(torch.int32)
    if name in ("reduce_shared", "reduce_warp"):
        xv = b["x"].view(grid.x, block.x)
        return lambda: xv.sum(1)
    if name == "matmul_tiled":
        xa, xb = b["a"], b["b"]
        return lambda: torch.matmul(xa, xb)
    if name == "softmax_row":
        x = b["x"]
        return lambda: torch.softmax(x, 1)
    if name == "scan_block":
        xv = b["x"].view(-1, block.x)
        return lambda: torch.cumsum(xv, 1)
    if name == "transpose_tiled":
        x = b["x"]
        return lambda: x.t().contiguous()
    if name == "lud_diag":
        tile = params["b"]
        a = b["a"][:grid.x * tile].reshape(grid.x, tile, tile)
        return lambda: torch.linalg.lu_factor(a, pivot=False)
    if name == "srad_stats":
        xv = b["x"].view(grid.x, block.x)
        return lambda: xv.sum(1)
    if name == "nn_reduce":
        tgt = b["target"]
        d = (b["lat"] - tgt[0]) ** 2 + (b["lng"] - tgt[1]) ** 2
        dv = torch.where(b["taken"] == 0, d, torch.inf).view(grid.x, block.x)
        val, idx = torch.min(dv, 1)
        rec = idx + block.x * torch.arange(grid.x, device=idx.device)
        if torch.equal(rec.to(torch.int32), got["pidx"]):
            return lambda: torch.min(dv, 1)
    return None


def launch_ms(kern, b, params, grid, block) -> float:
    """The kernel's time alone on the buffers ``b``: its written buffers
    restored between runs, outside the timed window."""
    pristine = {k: b[k].clone() for k in kern.writes}
    work = {**b, **{k: v.clone() for k, v in pristine.items()}}

    def restore():
        for k, v in pristine.items():
            work[k].copy_(v)

    return time_ms(lambda: kern.launch_into(work, grid, block, **params),
                   before=restore)


def bfs_chain_levels(kern, args, params, grid, block, cuda_suite, dev) -> dict:
    """bfs's kernel time at each of the chain's launches, each at the
    state that level sees, with its bound and the frontier's size."""
    dist = cuda_suite.bfs_levels(args["edges"], params["n"])
    out = {"ms": [], "bound_ms": [], "frontier": []}
    for level in range(int(dist.max()) + 1):
        state = bfs_state(args, dist, level)
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in state.items()}
        out["ms"].append(launch_ms(kern, b, params, grid, block))
        out["bound_ms"].append(bound("bfs_frontier", b, params, grid,
                                     block)[0])
        out["frontier"].append(int(state["frontier"].sum()))
    return out


def check_and_time(name, kern, b, params, grid, block, tol):
    """The kernel's row of the JSON line, and its launch's outputs."""
    got = kern(b, grid=grid, block=block, **params)
    want = kern.plain(b, grid, block, **params)
    torch.cuda.synchronize()
    err = compare(name, got, want, kern.writes, tol)
    ms = launch_ms(kern, b, params, grid, block)
    call_ms = time_ms(lambda: kern(b, grid=grid, block=block, **params))
    plain_ms = time_ms(lambda: kern.plain(b, grid, block, **params))
    lib = library_call(name, b, params, grid, block, got)
    library_ms = None if lib is None else time_ms(lib)
    bound_ms, bound_by = bound(name, b, params, grid, block)
    return {"name": name, "route": "cuda", "source": kern.source,
            "replaces": REPLACES, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "call_ms": call_ms}, got


def hot_inputs(rng) -> dict:
    """Each hot-path call's float32 inputs, drawn from ``rng``."""
    def draw(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    p = HOT["rmsnorm"]
    out = {"rmsnorm": (draw(p["rows"], p["d"]), draw(p["d"]))}
    p = HOT["matmul"]
    out["matmul"] = (draw(p["m"], p["k"]), draw(p["k"], p["n"]))
    for call in ("flash_attention_prefill", "flash_attention_decode"):
        p = HOT[call]
        out[call] = (draw(p["b"], p["h"], p["sq"], p["d"]),
                     draw(p["b"], p["hkv"], p["skv"], p["d"]),
                     draw(p["b"], p["hkv"], p["skv"], p["d"]))
    return out


def hot_tol(fn: str, dtype, matmul_tol) -> float:
    """The tolerance of tests/test_kernels.py for ``fn`` in ``dtype``;
    float32 matmul's grows with depth as ``matmul_tol(k)`` (4.5e-4 at
    k = 2048)."""
    if dtype == torch.bfloat16:
        return {"rmsnorm": 2e-2, "matmul": 5e-2, "flash_attention": 2e-2}[fn]
    if fn == "matmul":
        return matmul_tol(HOT["matmul"]["k"])
    return {"rmsnorm": 1e-5, "flash_attention": 2e-5}[fn]


def hot_bound(call: str, dtype) -> tuple[float, str]:
    """Least time (ms) for one hot-path call: its inputs read once and its
    output written once over the memory rate, against its flops over the
    peak rate for their type (bfloat16 tensor cores; float32 CUDA cores)
    and its ``exp`` over the special-function units."""
    p, size = HOT[call], torch.empty(0, dtype=dtype).element_size()
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    exps = 0.0
    if call == "rmsnorm":
        nbytes = size * 2 * p["rows"] * p["d"] + 4 * p["d"]
        flops = 4.0 * p["rows"] * p["d"]   # square-add, two products, add
    elif call == "matmul":
        m, k, n = p["m"], p["k"], p["n"]
        nbytes = size * (m * k + k * n + m * n)
        flops = 2.0 * m * k * n
    else:
        b, h, sq, skv, d = p["b"], p["h"], p["sq"], p["skv"], p["d"]
        # the (query, key) pairs the mask keeps: the top-left triangle
        pairs = (sum(min(skv, i + 1) for i in range(sq)) if p["causal"]
                 else sq * skv)
        nbytes = size * (2 * b * h * sq * d + 2 * b * p["hkv"] * skv * d)
        flops = 4.0 * d * b * h * pairs    # q.k and p.v
        exps = float(b * h * pairs)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(flops / peak, exps / SFU_OPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def hot_calls(call: str, t: tuple, ops, kernels_of) -> tuple:
    """``(fn name, ops call, plain call, oracle call, yardstick)`` for one
    hot-path call on the tensors ``t``."""
    import torch.nn.functional as F

    if call == "rmsnorm":
        x, scale = t
        w = (1.0 + scale).to(x.dtype)
        mod = kernels_of["rmsnorm"]
        return ("rmsnorm", lambda: ops.rmsnorm(x, scale),
                lambda: mod.rmsnorm_plain(x, scale),
                lambda: ops.rmsnorm(x, scale, mode="ref"),
                lambda: F.rms_norm(x, (x.shape[1],), weight=w, eps=1e-5))
    if call == "matmul":
        a, b = t
        mod = kernels_of["matmul"]
        return ("matmul", lambda: ops.matmul(a, b),
                lambda: mod.matmul_plain(a, b),
                lambda: ops.matmul(a, b, mode="ref"),
                lambda: torch.matmul(a, b))
    q, k, v = t
    causal = HOT[call]["causal"]
    mod = kernels_of["flash_attention"]
    return ("flash_attention",
            lambda: ops.flash_attention(q, k, v, causal=causal),
            lambda: mod.plain(q, k, v, causal=causal),
            lambda: ops.flash_attention(q, k, v, causal=causal, mode="ref"),
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))


def hot_phase(host: dict, dev, matmul_tol) -> dict:
    """Phase 4: each hot-path call through ``ops`` once per dtype with
    fresh counts (the main path), held against its plain version and the
    oracle, then timed.  Returns the kernels' JSON rows by name."""
    from repro_torch.core import lower_cuda
    from repro_torch.kernels import flash_attention, matmul, ops, rmsnorm

    kernels_of = {"rmsnorm": rmsnorm, "matmul": matmul,
                  "flash_attention": flash_attention}
    rows = {}
    for dtype in HOT_DTYPES:
        dname = str(dtype).removeprefix("torch.")
        for call in HOT:
            t = tuple(torch.from_numpy(a).to(dev).to(dtype)
                      for a in host[call])
            fn, run, plain, oracle, library = hot_calls(call, t, ops,
                                                        kernels_of)
            kname = HOT_KERNELS[call, dtype]
            # the main path: this call's kernel, once, and no other
            for kern in (*ops.KERNELS.values(), *lower_cuda.KERNELS.values()):
                kern.launches = 0
            torch.cuda.synchronize()
            got = run()
            torch.cuda.synchronize()
            counts = {n: k.launches for n, k in ops.KERNELS.items()}
            counts.update((n, k.launches) for n, k in
                          lower_cuda.KERNELS.items() if k.launches)
            launches = counts.pop(kname)
            if launches != 1 or any(counts.values()):
                raise AssertionError(f"{call}/{dname}: {kname} launched "
                                     f"{launches} times, others {counts}")
            tol = hot_tol(fn, dtype, matmul_tol)
            # flash attention's kernels hold their plain versions closer
            # than the oracle (PLAIN_TOL says why)
            plain_tol = (flash_attention.PLAIN_TOL[
                flash_attention.route(*t), dtype]
                if fn == "flash_attention" else (tol, tol))
            err = 0.0
            for what, want, (rtol, atol) in (
                    ("plain", plain(), plain_tol),
                    ("oracle", oracle(), (tol, tol))):
                if got.shape != want.shape or got.dtype != want.dtype or \
                        not torch.isfinite(got).all() or \
                        not torch.allclose(got.float(), want.float(),
                                           rtol=rtol, atol=atol):
                    raise AssertionError(f"{call}/{dname}: disagrees with "
                                         f"its {what} version")
                if what == "plain":
                    err = float((got.double() - want.double()).abs().max())
                del want
            del got
            ms = time_ms(run)
            plain_ms = time_ms(plain)
            library_ms = time_ms(library)
            bound_ms, bound_by = hot_bound(call, dtype)
            name = f"{kname}/{call}/{dname}"
            ctas = ""
            if kname == "matmul":
                m, n = HOT[call]["m"], HOT[call]["n"]
                ctas = f" ctas={matmul.simt_ctas(m, n)}"
            elif kname == "rmsnorm":
                ctas = f" ctas={rmsnorm.ctas(t[0].shape[0])}"
            elif kname == "flash_attention":
                B, H, Sq, d = t[0].shape
                ctas = (f" ctas={flash_attention.simt_ctas(B, H, Sq, d)} "
                        f"q_tile={flash_attention.simt_q_tile(d)}")
            rows[name] = {
                "name": name, "route": "cuda",
                "source": ops.KERNELS[kname].source,
                "replaces": HOT_REPLACES[fn], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
            print(f"hot {name}: {HOT[call]} kernel_ms={ms} "
                  f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by}) "
                  f"library_ms={library_ms} max_abs_err={err} "
                  f"plain_tol={plain_tol} tol={tol} "
                  f"launches={launches} oracle=match{ctas}")
            del t
            torch.cuda.empty_cache()
    return rows


def layer_us(entry, args: dict, dev, api, carry, kern, n=512) -> dict:
    """Per-launch wall time (us) of one chain step through each layer,
    over ``n`` launches of the chain's first step, card synchronised at
    both ends: the bare C launch, the wrapper (checks plus the functional
    copy of the written buffers), and ``api.launch`` (options, cache,
    backend registry) on top."""
    from repro_torch.core.dim3 import Dim3

    step = entry.chain.steps[0]
    grid, block = Dim3.of(step.grid), Dim3.of(step.block)
    params = dict(step.kernel.native.params)
    bufs = carry.from_reference(args, device=dev)
    work = {k: v.clone() for k, v in bufs.items()}
    runs = {
        "raw_us": lambda: kern.launch_into(work, grid, block, **params),
        "wrapper_us": lambda: kern(bufs, grid=grid, block=block, **params),
        "api_us": lambda: api.launch(step.kernel, grid=step.grid,
                                     block=step.block, args=bufs,
                                     backend="cuda"),
    }
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import carry
    from repro_torch.core import _native, api, cuda_suite, lower_cuda
    from repro_torch.core.dim3 import Dim3

    dev = torch.device("cuda")
    # float32 products in full float32 (the reference's): under TF32 the
    # plain version of matmul_tiled and its yardstick would compute
    # something else
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch: {torch.__version__} (CUDA {torch.version.cuda})")
    lib = _native.library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.2f} s "
          f"(nvcc, sm_90a, {len(_native.sources())} sources)")
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    ents = entries(cuda_suite)
    host_args = {n: e.make_args(rng) for n, e in ents.items()}
    hot_host = hot_inputs(rng)      # after every entry's inputs

    # ---- phase 2: each kernel against its plain version, and timed ------
    rows, kernels_of = {}, {}
    for name, entry in ents.items():
        b = launch_inputs(name, host_args[name], cuda_suite, dev)
        steps = cuda_suite.entry_steps(entry)
        kernels_of[name] = [step.kernel.name for step in steps]
        for j, step in enumerate(steps):
            if j and step.prepare is not None:
                b = {**b, **step.prepare(0, b)}
            kname = step.kernel.name
            kern = lower_cuda.KERNELS[kname]
            grid, block = Dim3.of(step.grid), Dim3.of(step.block)
            params = lower_cuda.launch_params(step.kernel, step.dyn_shared)
            rows[kname], got = check_and_time(kname, kern, b, params, grid,
                                              block, entry.tol)
            r = rows[kname]
            ctas = ""
            if kname == "matmul_tiled":
                cx, cy = lower_cuda.matmul_tiled_ctas(params["n"], grid.x)
                ctas = f" ctas={cx * cy} ({cx} x {cy})"
            elif kname in WARP_BLOCK_KERNELS:
                ctas = f" ctas={warp_block_ctas(grid.x, block.x)}"
            elif kname == "transpose_tiled":
                cx, cy = lower_cuda.transpose_tiled_ctas(
                    params["h"], params["w"], grid.x)
                side = lower_cuda.transpose_tiled_side()
                ctas = f" ctas={cx * cy} ({cx} x {cy} of {side} x {side})"
            elif kname == "hotspot":
                cx, cy = lower_cuda.hotspot_ctas(params["h"], params["w"],
                                                 grid)
                cr, cc = lower_cuda.hotspot_region()
                ctas = f" ctas={cx * cy} ({cx} x {cy} of {cr} x {cc})"
            elif kname == "bfs_frontier":
                lv = bfs_chain_levels(kern, host_args[name], params, grid,
                                      block, cuda_suite, dev)
                print("levels bfs_frontier: " + " ".join(
                    f"{k}={v}" for k, v in lv.items()))
                ctas = (f" levels_ms={sum(lv['ms'])} levels_bound_ms="
                        f"{sum(lv['bound_ms'])} ctas="
                        f"{lower_cuda.bfs_frontier_ctas(params['n'])} a pass")
            elif kname == "vecadd":
                # vecadd_ctas counts the launcher's 16-byte path; buffers
                # off 16 bytes would take its one-element path instead
                if any(b[k].data_ptr() % 16 for k in ("a", "b", "c")):
                    raise AssertionError("vecadd: a buffer lies off a "
                                         "16-byte boundary")
                n_ctas = lower_cuda.vecadd_ctas(params["n"], grid.x, block.x)
                ctas = f" ctas={n_ctas}"
            print(f"kernel {kname}: kernel_ms={r['ms']} "
                  f"call_ms={r['call_ms']} plain_ms={r['plain_ms']} "
                  f"bound_ms={r['bound_ms']} ({r['bound_by']}) "
                  f"library_ms={r['library_ms']} "
                  f"max_abs_err={r['max_abs_err']}{ctas}")
            b = {**b, **got}        # the state the next step starts from
        del b
    torch.cuda.synchronize()

    # ---- phase 3: the main path at Rodinia sizes ------------------------
    wants, oracle_s = {}, {}
    for n, e in ents.items():
        t0 = time.perf_counter()
        wants[n] = e.reference(host_args[n])
        oracle_s[n] = time.perf_counter() - t0
    stats = {n: cuda_suite.ChainStats() for n in ents}
    walls, launches = {}, {}
    for name, entry in ents.items():
        for kern in lower_cuda.KERNELS.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = cuda_suite.run_entry(entry, "cuda", args=host_args[name],
                                      with_reference=False, device=dev,
                                      chain_stats=stats[name])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts = {n: k.launches for n, k in lower_cuda.KERNELS.items()}
        launches[name] = {k: counts.pop(k) for k in kernels_of[name]}
        if any(counts.values()):
            raise AssertionError(f"{name}: other kernels launched: {counts}")
        for k, v in wants[name].items():
            got = out[k].cpu().numpy()
            if got.shape != v.shape or not np.isfinite(got).all() or \
                    not np.allclose(got, v, rtol=entry.tol, atol=entry.tol):
                raise AssertionError(f"{name}: {k} disagrees with the "
                                     f"oracle")
            exact = v.dtype.kind == "i" or name in EXACT_ENTRIES
            if exact and not np.array_equal(got, v):
                raise AssertionError(f"{name}: {k} not bit-identical")
        if name == "streamcluster":
            # the oracle has no ndirty: it counts the distinct centres
            # that switchers leave
            moved = np.unique(host_args[name]["assign"][
                wants[name]["switched"] == 1]).size
            if out["ndirty"].tolist() != [moved]:
                raise AssertionError(f"streamcluster: ndirty "
                                     f"{out['ndirty'].tolist()} != {moved}")
    for name, entry in ents.items():
        per_kernel = launches[name]
        ran = sum(per_kernel.values())
        expect = 1 if entry.chain is None else stats[name].launches
        if min(per_kernel.values()) == 0 or ran != expect:
            raise AssertionError(f"{name}: kernels counted {per_kernel}, "
                                 f"the entry ran {expect} launches")
        for kname, count in per_kernel.items():
            rows[kname]["launches"] = count
        print(f"main {name}: {SIZES[name]} wall_s={walls[name]} "
              f"launches={per_kernel} iterations={stats[name].iterations} "
              f"host_syncs={stats[name].host_syncs} "
              f"us_per_launch={walls[name] / ran * 1e6} "
              f"oracle_s={oracle_s[name]} oracle=match")

    nw = "needle_nw"
    layers = layer_us(ents[nw], host_args[nw], dev, api, carry,
                      lower_cuda.KERNELS[nw])
    layers["chain_us"] = walls[nw] / launches[nw][nw] * 1e6
    print(f"layers {nw}: " + " ".join(f"{k}={v}" for k, v in layers.items()))

    # ---- phase 4: the hot-path kernels at granite-3-2b's widths ---------
    rows.update(hot_phase(hot_host, dev, cuda_suite.matmul_tol))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
