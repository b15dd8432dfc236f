#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the ``nvcc`` build
   of ``src/repro_torch/csrc/*.cu`` into ``build/repro_torch/``;
2. per hand-written kernel (27 for the 23 entries: srad_step, nn and
   kmeans run two kernels an iteration, and the histogram entry runs a
   second time in its contiguous layout, ``VARIANTS``): one launch at the
   main path's shape through the kernel and through its plain PyTorch
   version on the same inputs on the card, compared (within the entry's
   ``tol`` for the float32 results of the ``TOLERANT`` kernels, bit for
   bit for every other kernel), then both timed with CUDA events, the
   median of 25 runs after warm-up.  A chain's first kernel runs on the
   entry's inputs, a later one on the state that one launch of each
   kernel before it leaves.
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
   for vecadd, reverse, both histogram layouts and matmul_tiled;
   ``torch.softmax``, the per-block ``torch.cumsum`` and
   ``x.t().contiguous()`` for softmax_row, scan_block and
   transpose_tiled).  Float32 matrix products run in full float32: TF32
   is switched off explicitly, or matmul_tiled's plain version and
   yardstick would compute something else.  The lines of matmul_tiled, of vecadd (CTAs of 256 threads that
   move two float4s each) and of the kernels that run a logical block a
   warp in CTAs of 256 (reduce_shared, reduce_warp, srad_stats,
   softmax_row: one row a warp, its values in registers, no barrier;
   scan_block: one block a warp, its levels in registers and shuffles)
   also give their physical CTA counts, as do transpose_tiled's (64 x
   64 squares of x, one barrier each, from
   ``lower_cuda.transpose_tiled_ctas``), stencil1d's and
   pixel_pipeline's (8 warps a CTA over 1,024 elements, four a lane, no
   barrier, ``lower_cuda.stencil1d_ctas`` and
   ``lower_cuda.pixel_pipeline_ctas``), both histogram layouts' (the
   pixels the reference's threads count, read as runs of consecutive
   pixels, a fixed count of them a CTA of 256 with 16-byte loads and a
   shared histogram, ``lower_cuda.histogram_ctas``), hotspot's and
   stencil2d's (8 warps a CTA over 8 x 128 cells,
   ``lower_cuda.hotspot_ctas`` and ``lower_cuda.stencil2d_ctas``),
   srad_update's (the same mapping,
   ``lower_cuda.srad_update_ctas``, after its fold over a cluster of 8
   CTAs), kmeans_assign's (a fixed number of points a CTA of 256,
   partials in registers, ``lower_cuda.kmeans_assign_ctas``),
   streamcluster's (the same mapping, savings and claims in shared bins,
   ``lower_cuda.streamcluster_ctas``), backprop_layer's (a thread-block
   cluster of CTAs a hidden unit, ``lower_cuda.backprop_layer_ctas``),
   lud_diag's (a tile in one warp's registers, 32 / P tiles a warp of
   P lanes each, no barrier, ``lower_cuda.lud_diag_ctas``), lavamd's
   (a CTA a home box, its width and the neighbours it stages at once
   from ``lower_cuda.lavamd_cta``),
   bfs_frontier's (1024 nodes a CTA of 256 in each of its two passes,
   ``lower_cuda.bfs_frontier_ctas``), needle_nw's (the diagonal's cells
   on CTAs of ``lower_cuda.needle_nw_cta_threads`` threads,
   ``lower_cuda.needle_nw_ctas``) and pathfinder's (stencil1d's mapping,
   ``lower_cuda.pathfinder_ctas``).  needle_nw's and pathfinder's lines
   also give ``pace_us``: ``PACE_LAUNCHES`` back-to-back in-place
   launches of the kernel (both launched as programmatic dependents of
   the work before them) between two CUDA events after a spin that
   covers their enqueue, over the count, median of ``PACE_RUNS``, with
   ``enqueue_us``, the host's time a launch, beside it; the window of
   ``ms`` holds one launch and cannot go below the launch's fixed cost.
   bfs_frontier's line also gives
   ``levels_ms``, its kernel time summed over the chain's launches, each
   timed at the state its level sees, and ``levels_bound_ms``, their
   bounds summed; the ``levels bfs_frontier`` line before it has each
   level's time, bound and frontier;
3. the main path: the eleven Rodinia entries at Rodinia 3.1's run-script
   sizes, and the twelve textbook entries at sizes that load the card
   (``SIZES``), then the histogram entry in its contiguous layout on the
   same pixels (``VARIANTS``), through ``run_entry(entry, backend="cuda")``
   - chevron/api/backends/``lower_cuda`` - with every launch count set to
   0 just before and read just after; each kernel of the entry must have
   launched, and their launches must sum to the chain's count.  Each
   entry is checked against the port's NumPy oracle (timed, since
   lavaMD's runs 27,000 NumPy steps): integer buffers and all of kmeans's
   bit for bit, the other float32 ones within the entry's ``tol``
   (``EXACT_ENTRIES`` bit for bit).  Seven entries are launch chains and
   sixteen single launches (seventeen runs with the contiguous
   histogram).  Every entry of ``SIZES`` draws its inputs from one
   generator seeded with ``SEED``, in its order; a variant takes its
   entry's;
3b. the seven chains again on the same inputs, device-resident
   (``chain_mode="device"``: update hooks on the card, the stop flag read
   back every ``check_every`` iterations) and graph-captured
   (``chain_mode="graph"``: the iterations after the first captured once
   into a ``torch.cuda.CUDAGraph`` and replayed), counted as in phase 3
   (a replay adds the captured launches to each kernel's count), each
   held against the oracle as in phase 3 and bit for bit against host
   mode outside ``SuiteEntry.iteration_state``.  A ``main_mode`` line per
   chain and mode gives the wall (one run, card synchronised at both
   ends), and for graph mode ``capture_s`` and ``replay_s`` from a second
   run with the capture and each replay synchronised at both ends, and
   ``replay_us``, the replay time per replayed launch - the steady state
   a replayed unit gives, which the wall of one run does not show, since
   the capture walks the host path once per launch.
   Then needle_nw's host time per launch, layer by layer, beside its
   per-launch wall in device mode (``device_us``) and replayed
   (``graph_replay_us``);
3c. the conformance matrix (``repro_torch.core.conformance``): all 23
   cases with every variant (grain 3, the Dim3 refactorizations, the
   f32/f64/i32 dtypes, a chain's device-resident leg, and its graph leg,
   which runs on ``cuda`` on the card, and every case's optimized leg,
   which runs on ``vector``) on ``CONFORMANCE_BACKENDS`` at
   ``build_suite(1)``'s sizes, case by case with every launch count set
   to 0 before the phase; a ``conformance <backend>`` line each with its
   cells by status and its seconds, a ``conformance legs`` line naming
   the backends of each replay leg, and the Table-II row of each backend
   (``coverage <backend>: correct= pct=`` beside the paper's 69.6 % and
   56.6 %).  Every passing ``cuda`` cell must have launched each kernel
   of its entry, and each of the 26 kernels of the 23 entries must have
   launched in the phase;
3d. the frontend (``repro_torch.frontend``): (a) each of the six corpus
   ``.cu`` kernels translated and run on ``vector`` with its buffers on
   the card at ``build_suite(1)``'s sizes, bit for bit the hand-written
   entry on ``vector`` and on ``cuda``, whose kernel must have launched
   (a ``frontend_gate <name>`` line each, with the twin's time a block);
   (b) each corpus source with its macros (vecadd's scalar ``n``) bound
   to an entry's parameters, checked against the source's ``#define``
   names and the entry's block, its twin on ``vector`` beside the
   hand-written entry on ``cuda`` on the same inputs, bit for bit (a
   ``frontend <name>: binds=... vector_wall_s=... cuda_wall_s=...
   ratio=... bits=equal`` line each, the card synchronised at both ends
   of each wall).  The sizes are ``FRONTEND_SIZES``'s, the entry's of
   ``SIZES`` first: the first whose ``vector`` run, projected from (a)'s
   time a block, fits ``FRONTEND_BUDGET_S`` runs, since the ``vector``
   lowering walks the grid a block at a time from the host (bfs: one
   level, or ``build_suite(1)``'s graph); a cut size's line says so;
3e. kernelcheck and the barrier-fission optimizer
   (``repro_torch.core.analyze`` / ``optimize``): (a) every entry of
   ``build_suite(1)`` analyzed with its buffers on the card, every report
   clean (a ``kernelcheck <kernel>: clean stages= fused_pairs= seconds=``
   line each) and the card's fusion artifacts equal to the CPU's in the
   same run; (b) each entry whose optimizer plan is not trivial on
   ``vector`` on the card, base and ``optimize=True`` in turns, best of
   ``OPT_TURNS`` each, bit for bit (``optimize <name>: stages=a->b
   vector_base_s= vector_opt_s= ratio= bits=equal``); (c) the sixteen
   single launches of ``SIZES`` on ``cuda`` with ``sanitize=True,
   optimize=True`` - the derived kernel keeps its hand-written kernel -
   and the seven chains at ``build_suite(1)``, each twice (the first
   launch analysed, the second memoized), counted as in phase 3 and bit
   for bit the plain ``cuda`` run (``sanitize_optimize <name>:
   launches= first_wall_s= memoized_wall_s= bits=equal``).  An entry
   whose analysis, projected from one analysed block, would pass
   ``SANITIZE_BUDGET_S`` runs at ``build_suite(1)``'s size, and its line
   says so;
3f. the serving tier and the on-disk compile cache
   (``repro_torch.serve``, ``repro_torch.core.compile_cache``): (a) a
   ``KernelService`` on ``cuda`` over the sixteen single launches of
   ``SIZES``, ``SERVE_ROWS`` input sets an endpoint queued twice before
   the worker starts, every result bit for bit its independent launch and
   its set's oracle, every request in a full batch, each kernel's count
   grown by its rows (a ``serve cuda <entry>`` line each: dispatches,
   p50/p99 latency, a warm batch's and a plain launch's wall a request;
   then ``serve stats`` with ``ServiceStats.to_json()``); (b)
   ``launch_batch`` on ``vector`` for vecadd, softmax_row and
   reduce_shared, bit for bit their launches; (c) the single launches of
   ``build_suite(1)`` on ``cuda`` with the disk cache on, then the same
   in a fresh interpreter (this script with ``--disk-child``) over that
   cache with an empty build directory: every launch a disk hit, no
   nvcc, no build time, the same bits (a ``disk_cache`` line);
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
5. the kernels' JSON line (the 27 suite kernels and a row per hot-path
   call and dtype, named ``<kernel>/<call>/<dtype>``), the card line, and
   last
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line,
as it does with no CUDA device or outside a checkout of the repository.
It imports neither JAX nor the reference package.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
TOLERANT = ("srad_update", "backprop_layer", "lavamd", "matmul_tiled",
            "softmax_row", "pixel_pipeline")
#: entries whose float32 results the oracle fixes bit for bit
EXACT_ENTRIES = ("kmeans", "vecadd", "stencil1d", "stencil2d",
                 "transpose_tiled")
BF16_OPS_PER_S = 989e12          # H100 SXM dense bfloat16 tensor cores
SLEEP_CYCLES = 1_000_000         # keeps the card busy while a run enqueues
RUNS, WARMUP = 25, 3
#: phase 2's pace_us: back-to-back in-place launches a run (needle_nw on
#: its longest diagonal, pathfinder on its first row; both idempotent on
#: fixed inputs), and the runs whose median is kept
PACE_LAUNCHES = {"needle_nw": 512, "pathfinder": 99}
PACE_RUNS = 5
#: the card's clock is at most this (cycles a second), so a spin of
#: seconds x this many cycles lasts at least that long
MAX_CLOCK_HZ = 2e9

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
#: entries run again with another option, on the inputs of the entry of
#: ``SIZES`` they vary: name -> (that entry, the option)
VARIANTS = {"histogram_contiguous": ("histogram", {"layout": "contiguous"})}


#: the hot-path calls at granite-3-2b's widths
#: (src/repro/configs/granite_3_2b.py: d_model 2048, 32 heads of 64, 8 kv
#: heads, d_ff 8192), over two sequences of train_4k's 4096 tokens
#: (src/repro/configs/registry.py:59); decode as attend_decode, one new
#: token for each of 32 sequences over a 4096-token cache
#: phase 3d (b): each corpus kernel's sizes, largest first.  The first is
#: the entry's size in SIZES (bfs, pathfinder and needle_nw at Rodinia
#: 3.1's; vecadd, reverse and stencil1d at the textbook sizes); the
#: others cut the problem (pathfinder its rows, the rest their length) and
#: keep the block, DEG and PENALTY.  The first size whose vector run,
#: projected from phase 3d (a)'s time per block, fits FRONTEND_BUDGET_S
#: runs: the vector lowering walks the grid one block at a time from the
#: host.  bfs's projection is of one level, and below its full size it
#: falls back to build_suite(1)'s graph
FRONTEND_SIZES = {
    "vecadd": [SIZES["vecadd"]] + [{"n": 1 << k, "block": 128}
                                   for k in (22, 20, 18, 16)],
    "reverse": [SIZES["reverse"]],
    "stencil1d": [SIZES["stencil1d"]] + [{"n": 1 << k, "block": 128}
                                         for k in (22, 20, 18, 16)],
    "bfs_frontier": [SIZES["bfs_frontier"], {"n": 64, "deg": 4}],
    "pathfinder": [SIZES["pathfinder"]]
    + [{"cols": 100_000, "rows": r} for r in (30, 10, 4)]
    + [{"cols": 16_384, "rows": 4}],
    "needle_nw": [SIZES["needle_nw"]] + [{"n": n, "penalty": 10}
                                         for n in (1024, 512, 256, 128)],
}
FRONTEND_BUDGET_S = 30.0
#: phase 3e: the analysis wall above which an entry's sanitized and
#: optimized cuda launch runs at build_suite(1)'s size, and the turns of
#: base and optimized vector runs whose best is kept
SANITIZE_BUDGET_S = 30.0
OPT_TURNS = 3
#: phase 3f: the distinct input sets (and the batch) an endpoint, and
#: the turns whose best wall is kept
SERVE_ROWS = 8
SERVE_TURNS = 3

#: the conformance phase's backends on the card (phase 3c); the loop
#: family stays off it: a pass takes 96 s on a CPU and would be
#: launch-bound here
CONFORMANCE_BACKENDS = ("vector", "cuda")

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


def pace_us(kern, b, params, grid, block,
            count) -> tuple[float, float, dict]:
    """Device time a launch (us) over ``count`` back-to-back in-place
    launches of the kernel on one stream between two CUDA events, median
    of ``PACE_RUNS``, the host's enqueue time a launch (us), and the
    buffers the launches wrote.

    A spin on the card covers the host's enqueue of the whole run (four
    times its measured length), so the window holds the launches as the
    card paces them and not as the host issues them.  The launches write
    copies of ``b``'s written buffers."""
    work = {**b, **{k: b[k].clone() for k in kern.writes}}

    def run():
        for _ in range(count):
            kern.launch_into(work, grid, block, **params)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * enqueue_s * MAX_CLOCK_HZ) + SLEEP_CYCLES
    times = []
    for _ in range(PACE_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / count)
    return statistics.median(times), enqueue_s / count * 1e6, work


def size_of(name: str) -> dict:
    """The entry function's arguments for ``name`` of ``SIZES`` or
    ``VARIANTS``."""
    if name in VARIANTS:
        base, option = VARIANTS[name]
        return {**SIZES[base], **option}
    return SIZES[name]


def entries(cuda_suite) -> dict:
    """Every entry of ``SIZES``, then of ``VARIANTS``, by name."""
    out = {}
    for name in (*SIZES, *VARIANTS):
        base = VARIANTS[name][0] if name in VARIANTS else name
        out[name] = getattr(cuda_suite, f"entry_{base}")(**size_of(name))
    return out


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
    elif name in ("histogram_coalesced", "histogram_contiguous"):
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
                      "softmax_row", "scan_block")


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
    if name in ("histogram_coalesced", "histogram_contiguous"):
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


def drive(cuda_suite, lower_cuda, entry, args, dev, kernels, **kw):
    """One ``run_entry`` on the card with every launch count set to 0 just
    before and read just after: the output, the wall (card synchronised
    at both ends) and the launches of each of ``kernels``; raises if any
    other kernel launched."""
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = cuda_suite.run_entry(entry, "cuda", args=args,
                                  with_reference=False, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: k.launches for n, k in lower_cuda.KERNELS.items()}
    per_kernel = {k: counts.pop(k) for k in kernels}
    if any(counts.values()):
        raise AssertionError(f"{entry.name}: other kernels launched: "
                             f"{counts}")
    return out, wall, per_kernel


def to_numpy(v) -> np.ndarray:
    """A buffer's values on the host: a tensor's, or a ConstArray's."""
    return getattr(v, "value", v).cpu().numpy()


def check_oracle(name: str, entry, out: dict, want: dict) -> None:
    """Finite, of the oracle's shape, within the entry's ``tol`` of it, and
    bit for bit on integer buffers and ``EXACT_ENTRIES``; raises."""
    for k, v in want.items():
        got = to_numpy(out[k])
        if got.shape != v.shape or not np.isfinite(got).all() or \
                not np.allclose(got, v, rtol=entry.tol, atol=entry.tol):
            raise AssertionError(f"{name}: {k} disagrees with the oracle")
        exact = v.dtype.kind == "i" or name in EXACT_ENTRIES
        if exact and not np.array_equal(got, v):
            raise AssertionError(f"{name}: {k} not bit-identical")


def graph_unit(chain) -> int:
    """The iterations one replay of ``chain``'s captured unit runs in graph
    mode (``LaunchChain.run_graph``'s rule)."""
    has_stop = chain.stop is not None or chain.device_stop is not None
    return min(chain.check_every, chain.repeat - 1) if has_stop \
        else chain.repeat - 1


@contextlib.contextmanager
def graph_spans(spans: dict, launch_chain, graph_exec):
    """Add to ``spans["capture"]`` and ``spans["replay"]`` the wall of each
    unit capture and each graph launch inside the block, the card
    synchronised at both ends of each."""
    capture, launch = launch_chain.capture_unit, graph_exec.launch

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                spans[key] += time.perf_counter() - t0
        return run

    launch_chain.capture_unit = timed(capture, "capture")
    graph_exec.launch = timed(launch, "replay")
    try:
        yield
    finally:
        launch_chain.capture_unit, graph_exec.launch = capture, launch


def conformance_phase(dev) -> None:
    """Phase 3c: the conformance matrix over all 23 cases with every
    variant, on ``CONFORMANCE_BACKENDS`` on the card, case by case with the
    card synchronised at both ends of each; then the Table-II rows of those
    backends (``benchmarks/torch_coverage.py``'s sweep).  Raises on any
    disagreement, on a passing ``cuda`` cell whose entry's kernels did not
    each launch, on a ``vector`` cell that launched a kernel, on a suite
    kernel that launched no time in the phase, and on a Table-II count
    below the committed baseline's."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import torch_coverage
    from repro_torch.core import conformance, cuda_suite, lower_cuda

    def counts():
        return {n: k.launches for n, k in lower_cuda.KERNELS.items()}

    cases = conformance.build_cases()
    suite_kernels = {s.kernel.name for case in cases for s in
                     cuda_suite.entry_steps(case.make(case.dtypes[0]))}
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0
    cells, legs, bad = [], {}, []
    seconds = dict.fromkeys(CONFORMANCE_BACKENDS, 0.0)
    for backend in CONFORMANCE_BACKENDS:
        for case in cases:
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = conformance.run_matrix([case], (backend,), variants=True,
                                         device=dev)
            torch.cuda.synchronize()
            seconds[backend] += time.perf_counter() - t0
            cells += rep.cells
            bad += rep.disagreements
            for mode, bs in rep.legs().items():
                legs.setdefault(mode, [])
                legs[mode] += [b for b in bs if b not in legs[mode]]
            for mode in ("optimized", "frontend"):
                legs.setdefault(mode, [])
                if backend not in legs[mode] and any(
                        c.mode == mode for c in rep.cells):
                    legs[mode].append(backend)
            ran = {k: v - before[k] for k, v in counts().items()}
            passed = sum(c.status == "pass" for c in rep.cells)
            mine = {s.kernel.name for s in cuda_suite.entry_steps(
                case.make(case.dtypes[0]))}
            if backend != "cuda" and any(ran.values()):
                raise AssertionError(f"{case.name}/{backend}: kernels "
                                     f"launched: {ran}")
            if backend == "cuda" and any(ran[k] < passed for k in mine):
                raise AssertionError(
                    f"{case.name}/cuda: {passed} passing cells, kernels "
                    f"launched {ran}")
    if bad:
        raise AssertionError("conformance disagreements: " + "; ".join(
            f"{c.label()} :: {c.detail}" for c in bad[:20]))
    launched = counts()
    idle = sorted(k for k in suite_kernels if not launched[k])
    if len(suite_kernels) != 26 or idle:
        raise AssertionError(f"conformance: of {len(suite_kernels)} suite "
                             f"kernels, {idle} launched no time")
    summary = conformance.Report(cells, len(cases),
                                 CONFORMANCE_BACKENDS).summary()
    for b in CONFORMANCE_BACKENDS:
        row = summary[b]
        print(f"conformance {b}: pass={row['pass']} fail={row['fail']} "
              f"unsupport={row['unsupport']} skip={row['skip']} "
              f"cells={sum(row.values())} seconds={seconds[b]}")
    print("conformance legs: " + " ".join(
        f"{m}={','.join(bs)}" for m, bs in legs.items())
        + f" kernels_launched={len(suite_kernels)} launches="
        + f"{sum(launched[k] for k in suite_kernels)}")

    table = torch_coverage.run(dev, backends=CONFORMANCE_BACKENDS)
    cov, pct = torch_coverage.counts(table), torch_coverage.percentages(table)
    with open(ROOT / "benchmarks" / "torch_coverage_baseline.json") as f:
        base = json.load(f)
    for fw in CONFORMANCE_BACKENDS:
        print(f"coverage {fw}: correct={cov[fw]}/{len(table)} "
              f"pct={pct[fw]:.1f} "
              f"paper_cupbop={torch_coverage.PAPER_CUPBOP_PCT} "
              f"paper_prior={torch_coverage.PAPER_PRIOR_PCT}")
        if cov[fw] < base["backends"][fw]:
            raise AssertionError(f"coverage {fw}: {cov[fw]} below the "
                                 f"baseline's {base['backends'][fw]}")


def frontend_binds(name: str, size: dict, entry, source: str) -> dict:
    """The corpus source's binds for the entry built from ``size``: its
    ``#define`` macros (vecadd's scalar ``n``) set to the entry's
    parameters, ``BLOCK`` and ``BD`` to the entry's block.  Raises unless
    every macro bound is one the source defines."""
    from repro_torch.core.dim3 import Dim3
    from repro_torch.frontend.lexer import macro_names

    block = Dim3.of(entry.block).size
    binds = {"vecadd": lambda: {"n": size["n"]},
             "reverse": lambda: {"BD": block},
             "stencil1d": lambda: {"NN": size["n"], "BLOCK": block},
             "bfs_frontier": lambda: {"N": size["n"], "DEG": size["deg"]},
             "pathfinder": lambda: {"COLS": size["cols"], "BLOCK": block},
             "needle_nw": lambda: {"N": size["n"],
                                   "PENALTY": size["penalty"]}}[name]()
    macros = macro_names(source)
    stray = set(binds) - macros - ({"n"} if name == "vecadd" else set())
    if stray:
        raise AssertionError(f"frontend {name}: {sorted(stray)} are not "
                             f"macros of the source ({sorted(macros)})")
    return binds


def frontend_block_runs(name: str, size: dict, entry) -> int:
    """The blocks the vector lowering walks for ``entry`` (for bfs, in
    one level): the grid times the chain's launches."""
    from repro_torch.core.dim3 import Dim3

    launches = (size["rows"] - 1 if name == "pathfinder"
                else 2 * size["n"] - 1 if name == "needle_nw" else 1)
    return Dim3.of(entry.grid).size * launches


def frontend_phase(dev, cuda_suite, lower_cuda) -> None:
    """Phase 3d: the frontend's corpus translated and run on the card.

    (a) each corpus twin on ``vector`` at ``build_suite(1)``'s sizes, bit
    for bit the hand-written entry on ``vector`` and on ``cuda``, whose
    kernel must have launched; (b) each twin at the largest size of
    ``FRONTEND_SIZES`` that fits ``FRONTEND_BUDGET_S``, its macros bound
    to the entry's parameters, on ``vector`` beside the hand-written
    entry on ``cuda`` on the same inputs, bit for bit.  Every wall has
    the card synchronised at both ends; a ``vector`` run must launch no
    suite kernel.  Raises on any disagreement."""
    from repro_torch.core.dim3 import Dim3
    from repro_torch.frontend import suite as fsuite

    def vector_run(entry, args):
        for kern in lower_cuda.KERNELS.values():
            kern.launches = 0
        stats = cuda_suite.ChainStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = cuda_suite.run_entry(entry, "vector", args=args,
                                      with_reference=False, device=dev,
                                      chain_stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {n: k.launches for n, k in lower_cuda.KERNELS.items()
               if k.launches}
        if ran:
            raise AssertionError(f"{entry.name}/vector launched {ran}")
        return out, wall, stats

    def bits(out):
        return {k: to_numpy(v).tobytes() for k, v in out.items()}

    def flat(args):
        return {k: v.reshape(-1) if v.ndim > 1 else v
                for k, v in args.items()}

    def same(name, what, got, want):
        bad = sorted(k for k in want if want[k] != got.get(k))
        if bad or set(got) != set(want):
            raise AssertionError(f"frontend {name}: twin differs from "
                                 f"{what} on {bad}")

    per_block = {}
    for name in fsuite.CORPUS:
        base = fsuite._bases()[name]
        twin = fsuite.frontend_twin(name)
        kernels = [s.kernel.name for s in cuda_suite.entry_steps(base)]
        args = base.make_args(np.random.default_rng(SEED))
        tw_out, tw_wall, st = vector_run(twin, flat(args))
        hv_out, hv_wall, _ = vector_run(base, args)
        hc_out, hc_wall, launched = drive(cuda_suite, lower_cuda, base,
                                          args, dev, kernels)
        tw = bits(tw_out)
        same(name, "the hand-written entry on vector", tw, bits(hv_out))
        same(name, "the hand-written entry on cuda", tw, bits(hc_out))
        if min(launched.values()) == 0:
            raise AssertionError(f"frontend {name}: cuda launched "
                                 f"{launched}")
        runs = Dim3.of(base.grid).size * max(1, st.launches)
        per_block[name] = tw_wall / runs
        print(f"frontend_gate {name}: vector=equal cuda=equal "
              f"launches={launched} twin_vector_wall_s={tw_wall} "
              f"hand_vector_wall_s={hv_wall} cuda_wall_s={hc_wall} "
              f"block_runs={runs} us_per_block={per_block[name] * 1e6}")

    rng = np.random.default_rng(SEED)
    for name, sizes in FRONTEND_SIZES.items():
        make = getattr(cuda_suite, f"entry_{name}")
        size, cut = None, ""
        for cand in sizes:
            entry = make(**cand)
            runs = frontend_block_runs(name, cand, entry)
            projected = runs * per_block[name]
            if projected <= FRONTEND_BUDGET_S:
                size = cand
                break
            if name == "bfs_frontier":
                size = sizes[-1]
                entry = make(**size)
                cut = (f" scale=1 (one level of {cand} projected "
                       f"{projected} s for {runs} blocks > "
                       f"{FRONTEND_BUDGET_S} s)")
                break
            if not cut:
                cut = (f" cut_from={cand} (projected {projected} s for "
                       f"{runs} blocks > {FRONTEND_BUDGET_S} s)")
        if size is None:
            raise AssertionError(f"frontend {name}: no size of "
                                 f"{sizes} fits {FRONTEND_BUDGET_S} s")
        binds = frontend_binds(name, size, entry, fsuite.corpus_source(name))
        twin = fsuite.frontend_twin(name, binds, base=entry)
        kernels = [s.kernel.name for s in cuda_suite.entry_steps(entry)]
        args = entry.make_args(rng)
        tw_out, tw_wall, st = vector_run(twin, flat(args))
        hc_out, hc_wall, launched = drive(cuda_suite, lower_cuda, entry,
                                          args, dev, kernels)
        same(name, "the cuda backend's kernel", bits(tw_out), bits(hc_out))
        if min(launched.values()) == 0:
            raise AssertionError(f"frontend {name}: cuda launched "
                                 f"{launched}")
        del tw_out, hc_out
        print(f"frontend {name}: binds={binds} size={size}{cut} "
              f"vector_wall_s={tw_wall} cuda_wall_s={hc_wall} "
              f"ratio={tw_wall / hc_wall} launches={launched} "
              f"vector_launches={st.launches} bits=equal")


def sync_wall(fn, *args, **kw):
    """``fn(*args, **kw)`` and its wall time, the card synchronised at
    both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernelcheck_phase(dev, cuda_suite, lower_cuda, ents, host_args) -> None:
    """Phase 3e: kernelcheck and the barrier-fission optimizer on the card.

    (a) every entry of ``build_suite(1)`` analyzed (reports and fusion
    artifacts) with its buffers on the card: every report clean, and
    ``fusion_to_json`` of the card's artifacts equal to the same call on
    the CPU in this run; (b) each entry whose plan is not trivial on
    ``vector`` on the card, base and ``optimize=True`` in turns, best of
    ``OPT_TURNS`` each, bit for bit; (c) the sixteen single-launch entries
    of ``SIZES`` on ``cuda`` with ``sanitize=True, optimize=True``, twice
    (the first launch analysed, the second memoized), each launch counted
    and bit for bit the plain ``cuda`` launch, and the seven chains the
    same way at ``build_suite(1)`` (``CUPBOP_SANITIZE=1`` and
    ``run_entry(optimize=True)``).  An entry whose analysis, projected
    from one analysed block, would take more than ``SANITIZE_BUDGET_S``
    runs at ``build_suite(1)``'s size instead, and its line says so.
    Raises on any finding, disagreement or kernel left unlaunched."""
    from repro_torch import carry
    from repro_torch.core import analyze, api, optimize

    def analysis(entry):
        return (analyze.analyze_entry(entry, device=dev),
                analyze.fusion_entry(entry, device=dev))

    def bits(out):
        return {k: to_numpy(v).tobytes() for k, v in out.items()}

    def counts():
        return {n: k.launches for n, k in lower_cuda.KERNELS.items()}

    # (a) the analyzer on the card, held against the CPU's artifacts
    small = cuda_suite.build_suite(1)
    arts_dev, arts_cpu = [], []
    for entry in small:
        for kern in lower_cuda.KERNELS.values():
            kern.launches = 0
        (reports, arts), secs = sync_wall(analysis, entry)
        if any(counts().values()):
            raise AssertionError(f"kernelcheck {entry.name}: the analysis "
                                 f"launched {counts()}")
        arts_dev += arts
        arts_cpu += analyze.fusion_entry(entry, device="cpu")
        for report, art in zip(reports, arts, strict=True):
            if not report.clean:
                raise AssertionError("\n".join(str(f)
                                                for f in report.findings))
            fused = optimize.plan_from_artifact(art).n_fused_pairs
            print(f"kernelcheck {report.kernel}: clean "
                  f"stages={art['n_stages']} fused_pairs={fused} "
                  f"entry={entry.name} seconds={secs}")
    if analyze.fusion_to_json(arts_dev) != analyze.fusion_to_json(arts_cpu):
        raise AssertionError("kernelcheck: the card's fusion artifacts "
                             "differ from the CPU's")
    summary = analyze.fusion_to_json(arts_dev)["summary"]
    print(f"kernelcheck fusion_to_json: equal to the cpu's "
          f"kernels={summary['n_kernels']} "
          f"adjacent_mergeable={summary['n_adjacent_mergeable']}/"
          f"{summary['n_adjacent_pairs']}")

    # (b) the optimizer on vector, where its plan is not trivial
    for entry in small:
        plans = {a["kernel"]: optimize.plan_from_artifact(a)
                 for a in arts_dev if a["kernel"] in
                 {s.kernel.name for s in cuda_suite.entry_steps(entry)}}
        if all(p.trivial for p in plans.values()):
            continue
        kw = dict(args=entry.make_args(np.random.default_rng(SEED)),
                  with_reference=False, device=dev)
        want = bits(cuda_suite.run_entry(entry, "vector", **kw)[0])
        # the first optimized run pays the analysis, outside the turns
        got = bits(cuda_suite.run_entry(entry, "vector", optimize=True,
                                        **kw)[0])
        walls = {None: [], True: []}
        for turn in range(OPT_TURNS):
            for opt in ((None, True) if turn % 2 == 0 else (True, None)):
                (out, _), wall = sync_wall(cuda_suite.run_entry, entry,
                                           "vector", optimize=opt, **kw)
                walls[opt].append(wall)
                if bits(out) != want:
                    raise AssertionError(f"optimize {entry.name}: bits "
                                         f"differ (optimize={opt})")
        if got != want:
            raise AssertionError(f"optimize {entry.name}: bits differ")
        stages = " ".join(
            f"{k}:{p.n_stages}->{p.n_stages - p.n_fused_pairs}"
            for k, p in plans.items())
        base_s, opt_s = min(walls[None]), min(walls[True])
        print(f"optimize {entry.name}: stages={stages} "
              f"vector_base_s={base_s} vector_opt_s={opt_s} "
              f"ratio={opt_s / base_s} bits=equal")

    # (c) the Hopper kernels under sanitize=True, optimize=True
    big = [(n, e, host_args[n]) for n, e in ents.items()
           if e.chain is None and n not in VARIANTS]
    chains = [(e.name, e, e.make_args(np.random.default_rng(SEED)))
              for e in small if e.chain is not None]
    small_by_name = {e.name: e for e in small}
    for name, entry, args in big + chains:
        kernels = [s.kernel.name for s in cuda_suite.entry_steps(entry)]
        note = "" if entry.chain is None else " scale=1 (a chain)"
        if entry.chain is None:
            bufs = carry.from_reference(args, const=entry.const, device=dev)
            _, probe = sync_wall(
                analyze.analyze_kernel, entry.kernel, grid=entry.grid,
                block=entry.block, args=bufs, dyn_shared=entry.dyn_shared,
                sample_blocks=1)
            projected = 2 * 3 * probe      # sanitize and optimize, 3 blocks
            if projected > SANITIZE_BUDGET_S:
                note = (f" scale=1 (projected {projected} s > "
                        f"{SANITIZE_BUDGET_S} s)")
                entry = small_by_name[entry.name]
                args = entry.make_args(np.random.default_rng(SEED))
            del bufs
        plain, _, plain_n = drive(cuda_suite, lower_cuda, entry, args, dev,
                                  kernels)
        want = bits(plain)
        del plain
        walls, launched = [], []
        for _ in range(2):
            for kern in lower_cuda.KERNELS.values():
                kern.launches = 0
            if entry.chain is None:
                bufs = carry.from_reference(args, const=entry.const,
                                            device=dev)
                out, wall = sync_wall(
                    api.launch, entry.kernel, grid=entry.grid,
                    block=entry.block, args=bufs,
                    dyn_shared=entry.dyn_shared, backend="cuda",
                    sanitize=True, optimize=True)
            else:
                os.environ["CUPBOP_SANITIZE"] = "1"
                try:
                    (out, _), wall = sync_wall(
                        cuda_suite.run_entry, entry, "cuda", args=args,
                        with_reference=False, device=dev, optimize=True)
                finally:
                    del os.environ["CUPBOP_SANITIZE"]
            ran = {k: lower_cuda.KERNELS[k].launches for k in kernels}
            if ran != plain_n:
                raise AssertionError(f"sanitize+optimize {name}: kernels "
                                     f"counted {ran}, plain {plain_n}")
            if bits(out) != want:
                raise AssertionError(f"sanitize+optimize {name}: bits "
                                     f"differ from the plain cuda launch")
            walls.append(wall)
            launched.append(ran)
            del out
        print(f"sanitize_optimize {name}:{note} launches={launched[0]} "
              f"first_wall_s={walls[0]} memoized_wall_s={walls[1]} "
              f"bits=equal")


def serve_phase(dev, cuda_suite, lower_cuda, ents, host_args, wants,
                build_seconds: float) -> None:
    """Phase 3f: the serving tier and the on-disk compile cache.

    (a) a ``KernelService`` on ``cuda`` over the sixteen single-launch
    entries of ``SIZES``: ``SERVE_ROWS`` distinct input sets an endpoint
    (the first phase 3's, set ``i`` drawn from a generator seeded with
    ``[SEED, i]``), queued as two waves of one request each (the second
    wave in the other order) before the worker starts.  Each set's
    independent ``api.launch`` on ``cuda`` is held against the oracle as
    in phase 3; every served result must be bit for bit its set's
    independent launch; no request may fail or fall through to a single
    dispatch, every dispatch must hold ``SERVE_ROWS`` requests, and each
    kernel's launch count must grow by its rows.  A ``serve cuda`` line
    an endpoint gives its dispatches, p50/p99 latency, and the wall a
    request of a warm batch entry (the rows' launches back to back) beside
    that of one plain ``api.launch`` on the same stream, best of
    ``SERVE_TURNS``; then the service's ``stats.to_json()`` with the wall
    of the 256 requests and of making the inputs (the new sets drawn,
    their oracles run and copied to the card on a thread a core).
    (b) ``launch_batch`` on ``vector`` at ``build_suite(1)`` for vecadd,
    softmax_row and reduce_shared, each row bit for bit its independent
    ``vector`` launch.
    (c) the disk cache across a process boundary: this process stores a
    record for each single-launch entry of ``build_suite(1)`` on ``cuda``
    (and the library), then a fresh interpreter (this script with
    ``--disk-child``) with ``CUPBOP_CACHE_DIR`` set and an empty build
    directory of its own relaunches them: every launch a disk hit, no
    nvcc (its ``_nvcc`` raises), no build time, every buffer the bits
    this process wrote.  A ``disk_cache`` line gives the counts, this
    process's build seconds and the child's first-launch wall."""
    import shutil
    import tempfile

    from repro_torch import carry
    from repro_torch.core import _native, api
    from repro_torch.serve import KernelService

    t_phase = time.perf_counter()
    # (a) the service on cuda at the main path's sizes; the host's draws,
    # oracles and copies of the new input sets run on a thread each core
    names = [n for n, e in ents.items()
             if e.chain is None and n not in VARIANTS]

    def draw(n, i):
        host = ents[n].make_args(np.random.default_rng([SEED, i]))
        want = ents[n].reference(host)
        return carry.from_reference(host, const=ents[n].const,
                                    device=dev), want

    with ThreadPoolExecutor(os.cpu_count()) as pool:
        drawn = {(n, i): pool.submit(draw, n, i) for n in names
                 for i in range(1, SERVE_ROWS)}
        drawn = {k: f.result() for k, f in drawn.items()}
    bufs = {n: [carry.from_reference(host_args[n], const=ents[n].const,
                                     device=dev)]
            + [drawn[n, i][0] for i in range(1, SERVE_ROWS)] for n in names}
    oracle = {(n, 0): wants[n] for n in names}
    oracle.update((k, want) for k, (_, want) in drawn.items())
    del drawn
    inputs_s = time.perf_counter() - t_phase

    def single(n, b):
        e = ents[n]
        return api.launch(e.kernel, grid=e.grid, block=e.block, args=b,
                          dyn_shared=e.dyn_shared, backend="cuda")

    def singles(n, rows):
        return [single(n, b) for b in rows]

    solo = {n: singles(n, bufs[n]) for n in names}
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        for f in [pool.submit(check_oracle, n, ents[n], solo[n][i],
                              oracle[n, i])
                  for n in names for i in range(SERVE_ROWS)]:
            f.result()
    del oracle
    waves = (range(SERVE_ROWS), range(SERVE_ROWS - 1, -1, -1))
    svc = KernelService(backend="cuda", max_batch=SERVE_ROWS,
                        autostart=False, device=dev,
                        max_queue=2 * SERVE_ROWS * len(names),
                        default_timeout_s=600.0)
    try:
        for n in names:
            svc.register_entry(ents[n])
        tickets = [(n, i, svc.submit(n, bufs[n][i]))
                   for wave in waves for n in names for i in wave]
        for kern in lower_cuda.KERNELS.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.start()
        served = [(n, i, t.result(timeout=600)) for n, i, t in tickets]
        serve_s = time.perf_counter() - t0
        counts = {k: v.launches for k, v in lower_cuda.KERNELS.items()}
    finally:
        svc.close()
    stats = svc.stats()
    if stats.failed or stats.completed != len(tickets):
        raise AssertionError(f"serve: {stats.failed} failed, "
                             f"{stats.completed} of {len(tickets)} done")
    if stats.batched_requests != len(tickets) or \
            set(stats.batch_occupancy) != {SERVE_ROWS}:
        raise AssertionError(
            f"serve: {stats.batched_requests} of {len(tickets)} requests "
            f"batched, occupancy {stats.batch_occupancy}: a batch fell "
            f"through to single dispatches")
    for n in names:
        kname = lower_cuda.kernel_for(ents[n].kernel).name
        ran = counts.pop(kname)
        if ran != 2 * SERVE_ROWS:
            raise AssertionError(f"serve {n}: {kname} launched {ran} "
                                 f"times, its rows {2 * SERVE_ROWS}")
    if any(counts.values()):
        raise AssertionError(f"serve: other kernels launched: {counts}")
    for n, i, out in served:
        for k in ents[n].kernel.writes:
            if not torch.equal(out[k], solo[n][i][k]):
                raise AssertionError(f"serve {n}: request {i}'s {k} is not "
                                     f"its independent launch's bits")
    del served, tickets
    for n in names:
        e, rows = ents[n], bufs[n]
        batch_s = min(sync_wall(
            api.launch_batch, e.kernel, grid=e.grid, block=e.block,
            args_list=rows, dyn_shared=e.dyn_shared, backend="cuda")[1]
            for _ in range(SERVE_TURNS))
        plain_s = min(sync_wall(singles, n, rows)[1]
                      for _ in range(SERVE_TURNS))
        lat = stats.kernels[n]
        print(f"serve cuda {n}: dispatches=2 rows={SERVE_ROWS} "
              f"p50_ms={lat['p50_ms']} p99_ms={lat['p99_ms']} "
              f"batch_ms_per_request={batch_s / SERVE_ROWS * 1e3} "
              f"single_ms_per_request={plain_s / SERVE_ROWS * 1e3} "
              f"ratio={batch_s / plain_s} bits=equal oracle=match")
    print(f"serve stats: requests={len(waves) * SERVE_ROWS * len(names)} "
          f"wall_s={serve_s} inputs_s={inputs_s} " + json.dumps(
              stats.to_json()))
    del bufs, solo
    api.cache_clear()
    torch.cuda.empty_cache()

    # (b) launch_batch on vector, rows bit for bit their launches
    for e in cuda_suite.build_suite(1):
        if e.name not in ("vecadd", "softmax_row", "reduce_shared"):
            continue
        brng = np.random.default_rng(SEED)
        rows = [carry.from_reference(e.make_args(brng), device=dev)
                for _ in range(4)]
        kw = dict(grid=e.grid, block=e.block, dyn_shared=e.dyn_shared,
                  backend="vector")
        got, batch_s = sync_wall(api.launch_batch, e.kernel,
                                 args_list=rows, **kw)
        for a, out in zip(rows, got):
            want = api.launch(e.kernel, args=a, **kw)
            for k in e.kernel.writes:
                if not torch.equal(out[k], want[k]):
                    raise AssertionError(f"launch_batch vector {e.name}: "
                                         f"{k} differs from its launch")
        print(f"launch_batch vector {e.name}: rows=4 wall_s={batch_s} "
              f"bits=equal")

    # (c) the disk cache across a process boundary
    tmp = Path(tempfile.mkdtemp(prefix="cupbop_cache_"))
    try:
        api.cache_clear()
        api.enable_disk_cache(str(tmp / "cache"))
        saved = {}
        try:
            for e in cuda_suite.build_suite(1):
                if e.chain is not None:
                    continue
                args = carry.from_reference(
                    e.make_args(np.random.default_rng(SEED)), const=e.const,
                    device=dev)
                out = api.launch(e.kernel, grid=e.grid, block=e.block,
                                 args=args, dyn_shared=e.dyn_shared,
                                 backend="cuda")
                saved.update((f"{e.name}/{k}", to_numpy(out[k]))
                             for k in e.kernel.writes)
            stored = api.cache_stats()
        finally:
            api.disable_disk_cache()
            api.cache_clear()
        lib = _native.library().path
        if stored.disk_stores != stored.misses or \
                stored.disk_stores != len(names):
            raise AssertionError(f"disk_cache: {stored}, {len(names)} "
                                 f"specializations")
        if (tmp / "cache" / lib.name).read_bytes() != lib.read_bytes():
            raise AssertionError("disk_cache: the library was not copied")
        np.savez(tmp / "bits.npz", **saved)
        env = {**os.environ, "CUPBOP_CACHE_DIR": str(tmp / "cache")}
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--disk-child",
             str(tmp / "bits.npz"), str(stored.disk_stores)],
            env=env, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"disk_cache child failed:\n{res.stdout}"
                                 f"{res.stderr}")
        child = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"disk_cache: stores={stored.disk_stores} "
              f"hits={child['disk_hits']} child_misses={child['misses']} "
              f"parent_build_s={build_seconds} "
              f"child_build_s={child['build_seconds']} "
              f"child_first_launch_s={child['first_launch_s']} "
              f"child_library={Path(child['library']).name} nvcc=none "
              f"bits=equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 3f: seconds={time.perf_counter() - t_phase}")


def disk_child(npz: str, stores: int) -> int:
    """Phase 3f (c)'s fresh process: with ``CUPBOP_CACHE_DIR`` set by the
    parent and an empty build directory of its own, relaunch the
    single-launch entries of ``build_suite(1)`` on ``cuda``; any nvcc run
    raises.  Prints one JSON line; raises on any disagreement."""
    import tempfile

    sys.path.insert(0, str(SRC))
    from repro_torch import carry
    from repro_torch.core import _native, api, cuda_suite

    _native.BUILD_DIR = Path(tempfile.mkdtemp(prefix="cupbop_build_"))

    def no_nvcc():
        raise AssertionError("nvcc ran in the child")
    _native._nvcc = no_nvcc
    saved = np.load(npz)
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)          # the context, outside the wall
    first = None
    for e in cuda_suite.build_suite(1):
        if e.chain is not None:
            continue
        args = carry.from_reference(e.make_args(np.random.default_rng(SEED)),
                                    const=e.const, device=dev)
        out, wall = sync_wall(api.launch, e.kernel, grid=e.grid,
                              block=e.block, args=args,
                              dyn_shared=e.dyn_shared, backend="cuda")
        first = wall if first is None else first
        for k in e.kernel.writes:
            if not np.array_equal(to_numpy(out[k]), saved[f"{e.name}/{k}"]):
                raise AssertionError(f"disk child {e.name}: {k} differs")
    s, lib = api.cache_stats(), _native.library()
    if (s.disk_hits, s.misses, s.disk_stores) != (stores, stores, 0) or \
            lib.build_seconds != 0 or \
            lib.path.parent != Path(api._DISK.path):
        raise AssertionError(f"disk child: {s}, library {lib.path} built "
                             f"in {lib.build_seconds} s")
    print(json.dumps({"disk_hits": s.disk_hits, "misses": s.misses,
                      "build_seconds": lib.build_seconds,
                      "first_launch_s": first, "library": str(lib.path)}))
    return 0


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
    host_args = {n: ents[n].make_args(rng) for n in SIZES}
    host_args.update((n, host_args[base]) for n, (base, _) in VARIANTS.items())
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
            elif kname in ("stencil1d", "pixel_pipeline"):
                per = getattr(lower_cuda, f"{kname}_cta_elems")()
                n_ctas = getattr(lower_cuda, f"{kname}_ctas")(
                    params["n"], grid.x, block.x)
                ctas = f" ctas={n_ctas} ({per} elements each)"
            elif kname.startswith("histogram_"):
                n_ctas = lower_cuda.histogram_ctas(
                    params["n"], params["total_threads"], grid.x, block.x,
                    kname.removeprefix("histogram_"))
                per = lower_cuda.histogram_cta_pixels()
                ctas = f" ctas={n_ctas} ({per} pixels each)"
            elif kname in ("hotspot", "stencil2d"):
                cx, cy = getattr(lower_cuda, f"{kname}_ctas")(
                    params["h"], params["w"], grid)
                cr, cc = getattr(lower_cuda, f"{kname}_region")()
                ctas = f" ctas={cx * cy} ({cx} x {cy} of {cr} x {cc})"
            elif kname == "srad_update":
                cx, cy = lower_cuda.srad_update_ctas(params["h"],
                                                     params["w"], grid)
                cr, cc = lower_cuda.srad_update_region()
                ctas = (f" ctas={cx * cy} ({cx} x {cy} of {cr} x {cc}, "
                        f"after a fold over a cluster of 8)")
            elif kname == "lavamd":
                threads, chunk = lower_cuda.lavamd_cta(params["ppb"],
                                                       params["nnei"])
                ctas = (f" ctas={grid.x} (a home box each, {threads} "
                        f"threads, {chunk} neighbours staged at once)")
            elif kname == "bfs_frontier":
                lv = bfs_chain_levels(kern, host_args[name], params, grid,
                                      block, cuda_suite, dev)
                print("levels bfs_frontier: " + " ".join(
                    f"{k}={v}" for k, v in lv.items()))
                ctas = (f" levels_ms={sum(lv['ms'])} levels_bound_ms="
                        f"{sum(lv['bound_ms'])} ctas="
                        f"{lower_cuda.bfs_frontier_ctas(params['n'])} a pass")
            elif kname in ("kmeans_assign", "streamcluster"):
                n_ctas = getattr(lower_cuda, f"{kname}_ctas")(
                    params["n"], grid.x, block.x)
                per = getattr(lower_cuda, f"{kname}_cta_points")()
                ctas = f" ctas={n_ctas} ({per} points each)"
            elif kname == "lud_diag":
                n_ctas = lower_cuda.lud_diag_ctas(params["b"], grid.x)
                per = lower_cuda.lud_diag_cta_tiles(params["b"])
                ctas = f" ctas={n_ctas} ({per} tiles each)"
            elif kname == "backprop_layer":
                n_ctas, c = lower_cuda.backprop_layer_ctas(params["in_n"],
                                                           grid.x)
                ctas = f" ctas={n_ctas} ({n_ctas // c} clusters of {c})"
            elif kname == "needle_nw":
                n_ctas = lower_cuda.needle_nw_ctas(grid.x, block.x)
                per = lower_cuda.needle_nw_cta_threads()
                ctas = f" ctas={n_ctas} ({per} threads each)"
            elif kname == "pathfinder":
                n_ctas = lower_cuda.pathfinder_ctas(params["cols"], grid.x,
                                                    block.x)
                per = lower_cuda.pathfinder_cta_cols()
                ctas = f" ctas={n_ctas} ({per} columns each)"
            elif kname == "vecadd":
                # vecadd_ctas counts the launcher's 16-byte path; buffers
                # off 16 bytes would take its one-element path instead
                if any(b[k].data_ptr() % 16 for k in ("a", "b", "c")):
                    raise AssertionError("vecadd: a buffer lies off a "
                                         "16-byte boundary")
                n_ctas = lower_cuda.vecadd_ctas(params["n"], grid.x, block.x)
                ctas = f" ctas={n_ctas}"
            if kname in PACE_LAUNCHES:
                count = PACE_LAUNCHES[kname]
                pace, enqueue, work = pace_us(kern, b, params, grid, block,
                                              count)
                compare(kname, work, got, kern.writes, entry.tol)
                ctas += (f" pace_us={pace} pace_launches={count} "
                         f"enqueue_us={enqueue}")
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
    walls, launches, host_outs = {}, {}, {}
    for name, entry in ents.items():
        out, walls[name], launches[name] = drive(
            cuda_suite, lower_cuda, entry, host_args[name], dev,
            kernels_of[name], chain_stats=stats[name])
        check_oracle(name, entry, out, wants[name])
        if entry.chain is not None:
            host_outs[name] = {k: to_numpy(v) for k, v in out.items()
                               if k not in entry.iteration_state}
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
        print(f"main {name}: {size_of(name)} wall_s={walls[name]} "
              f"launches={per_kernel} iterations={stats[name].iterations} "
              f"host_syncs={stats[name].host_syncs} "
              f"us_per_launch={walls[name] / ran * 1e6} "
              f"oracle_s={oracle_s[name]} oracle=match")

    # ---- phase 3b: the chains device-resident and graph-captured --------
    from repro_torch.core.graphs import GraphExec
    from repro_torch.core.kernel import LaunchChain

    per_launch = {}
    for name in host_outs:
        entry = ents[name]
        for mode in ("device", "graph"):
            st = cuda_suite.ChainStats()
            out, wall, per_kernel = drive(
                cuda_suite, lower_cuda, entry, host_args[name], dev,
                kernels_of[name], chain_stats=st, chain_mode=mode)
            ran = sum(per_kernel.values())
            if min(per_kernel.values()) == 0 or ran != st.launches:
                raise AssertionError(f"{name}/{mode}: kernels counted "
                                     f"{per_kernel}, the chain ran "
                                     f"{st.launches} launches")
            check_oracle(name, entry, out, wants[name])
            for k, v in host_outs[name].items():
                if not np.array_equal(to_numpy(out[k]), v):
                    raise AssertionError(f"{name}/{mode}: {k} differs from "
                                         f"host mode")
            del out
            spans = ""
            per_launch[name, mode] = wall / ran * 1e6
            if mode == "graph":
                t = {"capture": 0.0, "replay": 0.0}
                with graph_spans(t, LaunchChain, GraphExec):
                    cuda_suite.run_entry(entry, "cuda", args=host_args[name],
                                         with_reference=False, device=dev,
                                         chain_mode=mode)
                replayed = st.graph_replays * graph_unit(entry.chain) \
                    * len(entry.chain.steps)
                per_launch[name, "replay"] = t["replay"] / replayed * 1e6
                spans = (f" capture_s={t['capture']} replay_s={t['replay']} "
                         f"replayed_launches={replayed} "
                         f"replay_us={per_launch[name, 'replay']}")
            print(f"main_mode {name}: mode={mode} {size_of(name)} "
                  f"wall_s={wall}{spans} launches={per_kernel} "
                  f"iterations={st.iterations} host_syncs={st.host_syncs} "
                  f"graph_replays={st.graph_replays} "
                  f"us_per_launch={per_launch[name, mode]} oracle=match")

    nw = "needle_nw"
    layers = layer_us(ents[nw], host_args[nw], dev, api, carry,
                      lower_cuda.KERNELS[nw])
    layers["chain_us"] = walls[nw] / launches[nw][nw] * 1e6
    layers["device_us"] = per_launch[nw, "device"]
    layers["graph_replay_us"] = per_launch[nw, "replay"]
    print(f"layers {nw}: " + " ".join(f"{k}={v}" for k, v in layers.items()))

    # ---- phase 3c: the conformance matrix and Table II on the card ------
    conformance_phase(dev)

    # ---- phase 3d: the frontend's corpus translated, on the card --------
    frontend_phase(dev, cuda_suite, lower_cuda)

    # ---- phase 3e: kernelcheck and the optimizer on the card ------------
    kernelcheck_phase(dev, cuda_suite, lower_cuda, ents, host_args)

    # ---- phase 3f: the serving tier and the disk cache on the card -------
    serve_phase(dev, cuda_suite, lower_cuda, ents, host_args, wants,
                lib.build_seconds)

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
    if sys.argv[1:2] == ["--disk-child"] and torch.cuda.is_available():
        sys.exit(disk_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
