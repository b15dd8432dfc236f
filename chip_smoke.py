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
   ``lower_cuda.pathfinder_ctas``) and nn_reduce's (a warp a logical
   block on CTAs of ``lower_cuda.nn_reduce_cta_threads`` threads,
   ``lower_cuda.nn_reduce_ctas``; nn_select's is one warp a logical
   block) and kmeans_update's (a lane a cluster,
   ``lower_cuda.kmeans_update_ctas``) and reverse's (one CTA of
   ``lower_cuda.reverse_cta_threads`` threads).  The lines of needle_nw,
   pathfinder, nn_reduce, nn_select, kmeans_update and reverse also give
   ``pace_us``: ``PACE_LAUNCHES`` back-to-back in-place launches of the
   kernel (all six launched as programmatic dependents of the work before
   them, all idempotent on fixed inputs but reverse, which runs an odd
   count of times where one launch reverses its window) between two
   CUDA events after a spin that covers their enqueue, over the count,
   median of ``PACE_RUNS``, with ``enqueue_us``, the host's time a
   launch, beside it; the window of ``ms`` holds one launch and cannot go
   below the launch's fixed cost.  After the kernels, nn's NaN leg: each
   nn kernel once more on a copy of its inputs whose ``lat`` holds NaN at
   record 0, at a record in a lane's third register (t = 77 of block 3)
   and across block 5, each held bit for bit against its plain version,
   a NaN matching a NaN in the same place (``NAN_RECORDS``; a ``nan_leg``
   line each), since under NaN the arg-min tree's result depends on its
   pairs and their operand order.
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
   launched in the phase; ``shard_vector`` (the vector lowering's blocks
   over the pool, one card here) launches none and each of its host cells
   is bit for bit ``vector``'s.  Then the shard check: the pool on CUDA
   tensors (``shard pool:``), ``devices=2`` refused on the card's heap,
   and ``shard_vector`` / ``shard`` at ``devices=1`` bit for bit
   ``vector`` / ``loop`` on a vecadd of 4 blocks (``shard <backend>
   devices=1:`` lines), and the phase's seconds (``phase 3c:``);
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
   tensor-core kernels, decode the cluster kernel in bfloat16 and the
   split-kv kernel with its merge in float32,
   float32 matmul and prefill the CUDA-core kernels), and that kernel must
   launch exactly once, no other.  The CUDA-core matmul's line gives its
   CTA count (one a 128 x 128 tile of c, fed by 16-byte loads issued a
   slice ahead into two shared buffers), rmsnorm's its and its path
   (8 rows a CTA, a row in a warp's registers), the decode's its CTAs
   and parts of a kv group (a cluster's ranks in bfloat16, splits in
   float32) and their keys, and each prefill's its CTA count and
   query tile (the CUDA-core kernel's 256 queries a CTA at d = 64,
   register outer products, the next K/V tile in flight by cp.async; the
   tensor-core kernel's 192 at d = 64, three consumer warpgroups on wgmma
   fed by a TMA producer).  Each output is
   held against that kernel's plain version (flash attention at
   ``flash_attention.PLAIN_TOL``, the others at ``hot_tol``) and the
   ``ref`` oracle (``hot_tol``) on the card, then kernel, plain version
   and the PyTorch yardstick
   (``F.rms_norm``, ``torch.matmul``, ``F.scaled_dot_product_attention``,
   timed only) are timed as in phase 2.  The inputs are drawn from the
   same generator after every entry's.  Then two short lines in bfloat16
   (``HOT_EXTRA``, their own generator of ``SEED``): qwen2-0.5b's decode
   step, 4 slots over 1,024 keys, and rmsnorm's wide path (a CTA a row)
   at ``[1024, 8192]``;
5. the LM serving path (``repro_torch.serve.engine`` over
   ``repro_torch.models``) at qwen2-0.5b's full width in bfloat16 (24
   layers, d_model 896, 14 / 2 heads padded to 16 / 16, vocabulary
   151,936, tied embeddings, QKV bias), its weights drawn on the card from
   ``SEED``: the serve command's traffic (``LM_TRAFFIC``: 8 prompts of
   16 tokens, 12 new tokens each, 4 slots) under both stream policies,
   then one prompt of 1,024 tokens with 32 new (``LM_LONG``), each run
   with every launch count set to 0 just before and read just after;
   every request must finish with its tokens, and each prefill and decode
   step must have launched rmsnorm 2L + 1 times and the flash kernel that
   ``route`` picks for its shapes L times (the tensor-core prefill, the
   cluster decode), and no other kernel (``lm serve`` lines, with
   tokens/s, ``launches``, ``syncs`` and ``steps``).  Then the model
   against its plain versions (``mode="interpret"``) on the card on the
   same parameters, teacher-forced with the plain versions' greedy
   tokens: each step's max-abs logit gap within ``LM_TOL``, and the
   tokens equal wherever the plain version's top-1 / top-2 margin exceeds
   it (``lm check`` lines, the steps under the margin counted), the
   traffic on the weights of each of ``LM_CHECK_SEEDS``; the long
   request's served tokens equal the plain versions' up to the first step
   under the margin, and all of them the kernel path's own greedy loop at
   the engine's shapes.  Then a prefill at 16 and 1,024 tokens and a
   decode step of 4 slots timed (host wall, the card synchronised at both
   ends; the card's busy time and the five costliest kernels from a
   ``torch.profiler`` trace), and each kernel at the long prompt's
   shapes on its layer-0 inputs (rmsnorm with a drawn scale) against its
   plain version and the oracle, timed as in phase 4 beside
   ``F.rms_norm`` / ``F.scaled_dot_product_attention`` (``lm kernel``
   lines, ``launches`` the served runs' count);
6. the LM training path (``repro_torch.train.step`` over
   ``repro_torch.models``) at qwen2-0.5b's full width and depth in
   bfloat16, remat ``full``, AdamW with the config's float32 moments, a
   batch of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens from ``SyntheticLM``,
   weights drawn on the card from ``SEED``: one train step with every
   launch count set to 0 just before and read just after, which must
   have launched rmsnorm 2L + 1 times a forward and 2L more in remat's
   recompute and ``flash_attention_tc`` L + L times, and no other kernel
   (``train main``, with the peak memory); the step's loss, gradients and
   updated parameters against the same step through the plain versions
   (``mode="interpret"``) on the weights of each of ``TRAIN_CHECK_SEEDS``,
   within ``TRAIN_TOL`` (``train check`` lines); each flash route's lse
   (the tc and simt prefills and the decode route at phase 4's shapes,
   the tc prefill at the training shape) against its plain version within
   ``LSE_TOL``, its output with the lse bit for bit its output without
   (``train lse``); ``OVERFIT_STEPS`` steps on one batch at lr 1e-3, the
   last loss below the first; a train step timed as phase 5 times a
   decode step (``train step``: wall, busy, idle share, tokens/s, the
   costliest kernels); the trainable flash's forward and backward at the
   training shape beside SDPA's (``train flash``); each kernel at the
   training shapes against its plain version and the oracle
   (``train kernel`` lines, ``launches`` the main path's count); then
   ``launch.train.main`` for 3 steps on the card through the entry point,
   each step launching as the main path's;
7. the mixture-of-experts decoder (``repro_torch.models.moe``) at
   deepseek-moe-16b's full width and depth in bfloat16 (28 layers, 16
   heads of 128, 64 routed experts top-6 and 2 shared), weights drawn on
   the card from ``SEED`` after phase 6's are freed, the init's peak
   memory held to the parameters' bytes plus one layer's draws (``moe
   init``): (a) phase 5's traffic under both policies and its long prompt
   through the ``Engine``, each run with every launch count set to 0 just
   before and read just after, rmsnorm 2L + 1 and the routed flash kernel
   L a prefill and a decode step and no other kernel (``moe serve``), the
   long request's tokens equal to the kernel path's own greedy loop's,
   and a prefill at 16 and 1,024 tokens and a decode step of 4 slots
   timed as in phase 5 (``moe prefill``, ``moe decode``); (f) each kernel
   at the long prompt's shapes (d = 128 with 16 heads, D = 2048) as in
   phase 5 (``lm kernel``); (c) the ``sort`` dispatch's prefill of the
   long prompt twice, bit for bit, with (a)'s counts (``moe sort``); (b)
   on the weights of each of ``MOE_CHECK_SEEDS``, each layer run from the
   plain path's input to it through the kernels and through the plain
   versions with both paths' routing recorded: the tokens routed alike
   within ``MOE_LAYER_TOL``, a token that changed experts only where its
   plain k-th / (k+1)-th gate margin is within twice its gates' largest
   move, a kept status changed only in an expert whose queue a changed
   choice touched; the flipped share, the end-to-end logit gap and the
   share of equal greedy tokens printed, not gated (``moe check``); (d)
   a train step at full width, ``MOE_TRAIN_LAYERS`` deep (rmsnorm 4L + 1,
   ``flash_attention_tc`` 2L), the aux term finite and the loss falling
   over ``OVERFIT_STEPS`` steps on one batch (``moe train``); (e)
   musicgen-medium at full width and depth (``[B, S, 4]`` tokens) and
   internvl2-76b at full width, ``VLM_LAYERS`` deep (1,024 patch
   embeddings and 16 tokens): a prefill and ``AV_STEPS`` decode steps
   with (a)'s counts, teacher-forced against their plain versions within
   ``AV_TOL`` on two seeds' weights (``av check``);
8. the state-space mixers (``repro_torch.models.mamba2`` and ``rwkv6``)
   at full width and depth in bfloat16, each model's weights drawn on the
   card from ``SEED`` after the last's are freed (``ssm init``): (a)
   zamba2-7b (81 Mamba2 layers, the shared attention of 32 heads of 112
   before every 6th, 14 applications) and (b) rwkv6-1.6b (24 layers),
   each serving phase 5's traffic under both policies and its long prompt
   through the ``Engine``, every run with every launch count set to 0
   just before and read just after: rmsnorm 2L + A + 1 and the routed
   flash kernel A a prefill and a decode step (A = 14; for rwkv6 2L + 1
   and no flash), and no other kernel (``ssm serve``); the long request's
   tokens equal to the kernel path's own greedy loop's, and a prefill at
   16 and 1,024 tokens and a decode step of 4 slots timed as in phase 5
   (``ssm prefill``, ``ssm decode``); (c) on each of ``SSM_CHECK_SEEDS``'
   weights, the traffic's prompts teacher-forced through the kernels
   against the plain versions on the card within ``SSM_TOL`` with greedy
   tokens equal above that margin, and prefill then decode against
   forward through the kernels within ``SSM_CONSISTENCY_TOL`` (``ssm
   check``); (d) a train step, remat full, 4 x 1,024 tokens: zamba2-7b
   at full width and ``SSM_TRAIN_LAYERS`` deep (one block of 6 and a
   tail of 2: rmsnorm 2(2L + A) + 1 and ``flash_attention_tc`` 2A), and
   rwkv6-1.6b at full width and depth (rmsnorm 4L + 1), the loss falling
   over ``OVERFIT_STEPS`` steps on one batch (``ssm train``); (e) the
   kernels at zamba2's shapes, each against its plain version, the oracle
   and PyTorch's call: the tc prefill and the decode at d = 112 with 32
   heads over the long prompt, rmsnorm in bfloat16 at ``[1024, 3584]``
   and in float32 at ``[1024, 7168]`` (Mamba2's gated norm, on the
   kernel's wide path, a CTA a row) (``ssm kernel``); the phase's
   seconds beside its ceiling of ``SSM_CEILING_S``;
9. the mesh path (``mesh_phase``): a process group of one rank (NCCL)
   and a ``1x1`` ``(data, model)`` mesh; phase 6's train step under
   ``use_mesh`` with ``shard_params``, every launch count set to 0 just
   before and read just after (rmsnorm 4L + 1, flash_attention_tc 2L and
   no other kernel), bit for bit the step without a mesh (``mesh
   main``); ``compressed_psum`` over the group on the step's gradients,
   timed (``mesh psum``); a checkpoint saved without a mesh restored
   onto it bit for bit (``mesh restore``); the cost analysis of the step
   on meta tensors, its argument bytes the card's (``mesh analysis``);
   one dry-run cell on the 16x16 fake mesh in a child process (``mesh
   dryrun``); the phase's seconds beside ``MESH_CEILING_S``;
10. the kernels' JSON line (the 27 suite kernels, a row per hot-path
   call and dtype, named ``<kernel>/<call>/<dtype>``, a row per kernel of
   the LM path, ``<kernel>/lm_qwen2-0.5b/bfloat16``,
   ``<kernel>/lm_deepseek-moe-16b/bfloat16`` and
   ``<kernel>/ssm_zamba2-7b/<dtype>``, and of the training path,
   ``<kernel>/lm_train_qwen2-0.5b/bfloat16``), the card line, and last
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
#: its longest diagonal, pathfinder on its first row, nn's two kernels on
#: their first iteration, kmeans_update on the sums of the first; all
#: idempotent on fixed inputs; reverse, an involution where its extent is
#: its block, an odd count of times, which equals its one launch), and the
#: runs whose median is kept
PACE_LAUNCHES = {"needle_nw": 512, "pathfinder": 99, "nn_reduce": 512,
                 "nn_select": 512, "kmeans_update": 512, "reverse": 511}
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

#: the conformance phase's backends on the card (phase 3c), vector before
#: shard_vector, whose cells are held against vector's bits; the loop
#: family stays off it, shard with it (its inner lowering is loop): a pass
#: takes 96 s on a CPU and would be launch-bound here
CONFORMANCE_BACKENDS = ("vector", "shard_vector", "cuda")

HOT = {
    "rmsnorm": {"rows": 2 * 4096, "d": 2048},
    "matmul": {"m": 2 * 4096, "k": 2048, "n": 8192},   # the MLP's up proj
    "flash_attention_prefill": {"b": 2, "h": 32, "hkv": 8, "sq": 4096,
                                "skv": 4096, "d": 64, "causal": True},
    "flash_attention_decode": {"b": 32, "h": 32, "hkv": 8, "sq": 1,
                               "skv": 4096, "d": 64, "causal": False},
}
#: phase 4's short lines, bfloat16: qwen2-0.5b's decode step (4 slots
#: over 1,024 keys, 14 / 2 heads of 64 padded to 16 / 16: PERF.md §4) and
#: rmsnorm's wide path at internvl2-76b's d_model (1,024 rows of 8,192)
HOT_EXTRA = {
    "flash_attention_decode_qwen2": {"b": 4, "h": 16, "hkv": 16, "sq": 1,
                                     "skv": 1024, "d": 64, "causal": False},
    "rmsnorm_wide": {"rows": 1024, "d": 8192},
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
#: phase 5: the LM serving path at qwen2-0.5b's full width, random
#: weights from SEED: the serve command's traffic (``--lm``'s defaults:
#: max_len = prompt + new + 8) under both policies, then one long prompt,
#: whose prefill walks 16 kv tiles and whose decode steps several splits
LM_ARCH = "qwen2-0.5b"
LM_TRAFFIC = {"requests": 8, "prompt_len": 16, "max_new": 12, "slots": 4}
LM_LONG = {"prompt_len": 1024, "max_new": 32}
#: max-abs gap of the kernels' logits from their plain versions' on the
#: card, teacher-forced: in bfloat16 a kernel's value may land on the
#: neighbouring bfloat16 value (flash_attention.PLAIN_TOL) and the layers
#: after it carry that into the logits, rounded to bfloat16 themselves
#: (the check line prints their largest size, ``logit_max``).  Measured at
#: most 2.93e-3 on an H100 (PERF.md)
LM_TOL = 5e-3
#: the weights' seeds whose traffic is checked against the plain versions:
#: the served model's and one more, so LM_TOL rests on two draws
LM_CHECK_SEEDS = (SEED, SEED + 1)
#: timed runs of a prefill or a decode step, after one more, median kept
LM_TURNS = 5
#: phase 6: the LM training path at qwen2-0.5b's full width and depth in
#: bfloat16, remat "full", AdamW with the config's float32 moments, a
#: batch of 4 x 1,024 tokens from SyntheticLM (4,096 tokens a step)
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
#: a train step through the kernels against the same step through their
#: plain versions on the card (``mode="interpret"``), same parameters and
#: batch: (loss and grad norm, relative; the worst gradient leaf's
#: ||dg|| / ||g||; the worst parameter leaf's ||dp|| / ||p|| after one
#: AdamW update).  In bfloat16 a kernel's value may land on the
#: neighbouring bfloat16 value (flash_attention.PLAIN_TOL), which every
#: layer after it and the whole backward carry on.  The worst leaf of
#: both is the k bias: it starts at 0, softmax nearly ignores it (a bias
#: shared by a row's keys shifts every score alike but for rope), so its
#: gradient is near 0 and rounding picks the sign of some elements, and
#: AdamW's first step moves each element by lr whatever the gradient's
#: size.  Each is 1.5 times the largest gap measured over
#: TRAIN_CHECK_SEEDS on an H100 (PERF.md): loss 1.20e-6,
#: grad norm 9.80e-5, a gradient leaf 6.62e-3, a parameter leaf 7.11e-2
TRAIN_TOL = {"loss": 1.8e-6, "grad_norm": 1.5e-4, "grad": 1e-2,
             "param": 0.107}
TRAIN_CHECK_SEEDS = (SEED, SEED + 1)
#: a route's lse against its plain version's (max-abs, natural log)
LSE_TOL = 1e-4
#: the reference's test_overfit_tiny_batch: steps on one batch at lr 1e-3
OVERFIT_STEPS = 8
#: phase 7: the mixture-of-experts decoder at deepseek-moe-16b's full
#: width and depth in bfloat16 (28 layers, d_model 2048, 16 heads of 128,
#: 64 routed experts top-6 and 2 shared, 16.9 B parameters), weights drawn
#: on the card from SEED, serving phase 5's traffic and long prompt
MOE_ARCH = "deepseek-moe-16b"
#: (b): the weights' seeds of the routing-aware check
MOE_CHECK_SEEDS = (SEED, SEED + 1)
#: (b): max-abs gap of a layer's output through the kernels from its
#: output through the plain versions, from the same input, over the
#: tokens routed alike by both (the same experts, each kept or dropped
#: alike).  A kernel's last-bit difference may flip a token's k-th expert
#: (the token then goes another way, and its gap is no rounding gap), so
#: flipped tokens are held to their gates instead (``moe_routing_check``).
#: 1.5 times the largest gap measured over MOE_CHECK_SEEDS on an H100
#: (PERF.md): 6.25e-2, one bfloat16 step of a value in [8, 16)
MOE_LAYER_TOL = 9.4e-2
#: (d): the train step's depth: full depth with AdamW's float32 moments
#: would need about 200 GB
MOE_TRAIN_LAYERS = 2
#: (e): the audio config at full width and depth, the VLM config at full
#: width with its depth cut (for memory: 80 layers are 152 GB in
#: bfloat16); prompts of AV_SEQ tokens (4 codebooks a position for the
#: audio config, LM_TRAFFIC's slots as the batch; the VLM config's after
#: its 1,024 patch embeddings), then AV_STEPS decode steps teacher-forced
AUDIO_ARCH, VLM_ARCH, VLM_LAYERS = "musicgen-medium", "internvl2-76b", 2
AV_SEQ, AV_STEPS = 16, 4
AV_CHECK_SEEDS = (SEED, SEED + 1)
#: (e): max-abs gap of the kernels' logits from their plain versions' on
#: the card, teacher-forced, as LM_TOL: 1.5 times the largest gap measured
#: over AV_CHECK_SEEDS on an H100 (PERF.md), 4.44e-2 for musicgen-medium's
#: 48 layers (logits up to 2.7) and 1.76e-2 for internvl2-76b's 2
AV_TOL = {AUDIO_ARCH: 6.7e-2, VLM_ARCH: 2.6e-2}
#: phase 8: the state-space mixers at full width and depth in bfloat16,
#: weights drawn on the card from SEED: zamba2-7b (81 Mamba2 layers of
#: d_inner 7,168, 112 heads of 64, state 64, chunk 64, and the shared
#: attention, 32 heads of 112, before every 6th layer: 14 applications;
#: 6.5 G parameters) and rwkv6-1.6b (24 layers, d 2,048, 32 heads of 64,
#: d_ff 7,168, vocab 65,536; 1.6 G), each serving phase 5's traffic and
#: long prompt
SSM_ARCHS = ("zamba2-7b", "rwkv6-1.6b")
#: (c): the weights' seeds whose traffic is checked against the plain
#: versions
SSM_CHECK_SEEDS = (SEED, SEED + 1)
#: (c): max-abs gap of the kernels' logits from their plain versions' on
#: the card, teacher-forced, as LM_TOL.  A kernel's value may land on the
#: neighbouring bfloat16 value (rmsnorm's, flash_attention.PLAIN_TOL), and
#: the layers after it carry that into the logits, each rounding to
#: bfloat16 again: 81 layers for zamba2, and rwkv6's recurrences, where one
#: step of one norm in the prefill grows to 0.19 in seed 43's logits (seed
#: 42's prefill gives the plain versions' bits).  1.5 times the largest gap
#: measured over SSM_CHECK_SEEDS on an H100 (PERF.md): 0.180 for zamba2-7b,
#: 0.356 for rwkv6-1.6b (logits up to about 3)
SSM_TOL = {"zamba2-7b": 0.27, "rwkv6-1.6b": 0.54}
#: (c): max-abs gap of a prefill and its decode steps through the kernels
#: from forward's logits through the kernels (tests/test_models.py's
#: _consistency at full width and depth, in bfloat16: a prefill and the
#: decode recurrences round in other places than forward's chunks).  1.5
#: times the largest gap measured over SSM_CHECK_SEEDS on an H100
#: (PERF.md): 0.123 for zamba2-7b, 0.145 for rwkv6-1.6b
SSM_CONSISTENCY_TOL = {"zamba2-7b": 0.19, "rwkv6-1.6b": 0.22}
#: (d): the train step's depth: zamba2-7b one block of 6 and a tail of 2
#: (2 shared-attention applications), rwkv6-1.6b its full 24
SSM_TRAIN_LAYERS = {"zamba2-7b": 8, "rwkv6-1.6b": 24}
#: phase 8's ceiling (s), printed beside its seconds: the script stays
#: under 600 s
SSM_CEILING_S = 90.0


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


def nan_records(block: int) -> list:
    """The records phase 2's NaN leg sets to NaN in ``lat``, for logical
    blocks of ``block`` records: the first, one in a lane's third register
    (t = 77 of block 3) and all of block 5."""
    return [0, 3 * block + min(77, block - 1),
            *range(5 * block, 6 * block)]


def same_bits(g: torch.Tensor, w: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN matching any NaN in the same place."""
    if g.shape != w.shape or g.dtype != w.dtype:
        return False
    if not g.dtype.is_floating_point:
        return torch.equal(g, w)
    gn, wn = torch.isnan(g), torch.isnan(w)
    return torch.equal(gn, wn) and torch.equal(
        g[~gn].view(torch.int32), w[~wn].view(torch.int32))


def nan_leg(entry, args: dict, cuda_suite, lower_cuda, dev) -> None:
    """nn's two kernels once each on a copy of the entry's first state
    with NaN distances (``nan_records``), each against its plain version
    bit for bit; raises on a difference."""
    from repro_torch.core.dim3 import Dim3

    b = launch_inputs("nn", args, cuda_suite, dev)
    steps = cuda_suite.entry_steps(entry)
    recs = nan_records(Dim3.of(steps[0].block).x)
    b["lat"] = b["lat"].clone()
    b["lat"][recs] = float("nan")
    for j, step in enumerate(steps):
        if j and step.prepare is not None:
            b = {**b, **step.prepare(0, b)}
        kern = lower_cuda.KERNELS[step.kernel.name]
        grid, block = Dim3.of(step.grid), Dim3.of(step.block)
        params = lower_cuda.launch_params(step.kernel, step.dyn_shared)
        got = kern(b, grid=grid, block=block, **params)
        want = kern.plain(b, grid, block, **params)
        torch.cuda.synchronize()
        for k in kern.writes:
            if not same_bits(got[k], want[k]):
                raise AssertionError(f"nan_leg {kern.name}: {k} differs "
                                     f"from plain")
        nans = {k: int(torch.isnan(got[k]).sum()) for k in kern.writes
                if got[k].dtype.is_floating_point}
        print(f"nan_leg {kern.name}: nan_records={len(recs)} (0, "
              f"{recs[1]}, {recs[2]}..{recs[-1]}) nan_outputs={nans} "
              f"bits=equal")
        b = {**b, **got}


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


def hot_bound(fn: str, dtype, p: dict) -> tuple[float, str]:
    """Least time (ms) for one call of ``fn`` at ``p``'s shapes: its inputs
    read once and its output written once over the memory rate, against
    its flops over the peak rate for their type (bfloat16 tensor cores;
    float32 CUDA cores) and its ``exp`` over the special-function units."""
    size = torch.empty(0, dtype=dtype).element_size()
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    exps = 0.0
    if fn == "rmsnorm":
        nbytes = size * 2 * p["rows"] * p["d"] + 4 * p["d"]
        flops = 4.0 * p["rows"] * p["d"]   # square-add, two products, add
    elif fn == "matmul":
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


def kernel_row(label: str, name: str, kname: str, fn: str, p: dict,
               dtype, fns: tuple, tols: tuple, launches=None,
               note: str = "") -> dict:
    """One kernel's JSON row.  ``fns`` is ``(run, plain, oracle, library)``:
    ``run`` (its ``ops`` call) is launched once with every count set to 0
    and must launch ``kname`` once and no other kernel; its result is held
    against ``plain`` within ``tols[0]`` (rtol, atol) and ``oracle`` within
    ``tols[1]``; then ``run``, ``plain`` and ``library`` are timed and the
    bound taken from ``p``, the shapes of ``fn``'s call.  ``launches`` is the main
    path's count (default: this one launch's)."""
    from repro_torch.core import lower_cuda
    from repro_torch.kernels import ops

    run, plain, oracle, library = fns
    plain_tol, tol = tols
    kernels = {**ops.KERNELS, **lower_cuda.KERNELS}
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    got = run()
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items() if k.launches}
    if counts != {kname: 1}:
        raise AssertionError(f"{name}: launched {counts}, not {kname} once")
    err = 0.0
    for what, want, (rtol, atol) in (("plain", plain(), plain_tol),
                                     ("oracle", oracle(), (tol, tol))):
        if got.shape != want.shape or got.dtype != want.dtype or \
                not torch.isfinite(got).all() or \
                not torch.allclose(got.float(), want.float(), rtol=rtol,
                                   atol=atol):
            raise AssertionError(f"{name}: disagrees with its {what} "
                                 f"version")
        if what == "plain":
            err = float((got.double() - want.double()).abs().max())
        del want
    del got
    ms, plain_ms, library_ms = time_ms(run), time_ms(plain), time_ms(library)
    bound_ms, bound_by = hot_bound(fn, dtype, p)
    launches = 1 if launches is None else launches
    print(f"{label} {name}: {p} kernel_ms={ms} plain_ms={plain_ms} "
          f"bound_ms={bound_ms} ({bound_by}) library_ms={library_ms} "
          f"max_abs_err={err} plain_tol={plain_tol} tol={tol} "
          f"launches={launches} oracle=match{note}")
    return {"name": name, "route": "cuda", "source": ops.KERNELS[kname].source,
            "replaces": HOT_REPLACES[fn],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def hot_phase(host: dict, dev, matmul_tol) -> dict:
    """Phase 4: each hot-path call through ``ops`` once per dtype with
    fresh counts (the main path), held against its plain version and the
    oracle, then timed.  Returns the kernels' JSON rows by name."""
    from repro_torch.kernels import flash_attention, matmul, ops, rmsnorm

    kernels_of = {"rmsnorm": rmsnorm, "matmul": matmul,
                  "flash_attention": flash_attention}
    rows = {}
    for dtype in HOT_DTYPES:
        dname = str(dtype).removeprefix("torch.")
        for call in HOT:
            t = tuple(torch.from_numpy(a).to(dev).to(dtype)
                      for a in host[call])
            fn, *fns = hot_calls(call, t, ops, kernels_of)
            kname = HOT_KERNELS[call, dtype]
            tol = hot_tol(fn, dtype, matmul_tol)
            # flash attention's kernels hold their plain versions closer
            # than the oracle (PLAIN_TOL says why)
            plain_tol = (flash_attention.PLAIN_TOL[
                flash_attention.route(*t), dtype]
                if fn == "flash_attention" else (tol, tol))
            ctas = ""
            if kname == "matmul":
                m, n = HOT[call]["m"], HOT[call]["n"]
                ctas = f" ctas={matmul.simt_ctas(m, n)}"
            elif kname == "rmsnorm":
                rows_, d_ = t[0].shape
                ctas = (f" ctas={rmsnorm.ctas(rows_, d_, dtype)} "
                        f"path={rmsnorm.path(d_, dtype)}")
            elif kname == "flash_decode":
                B, H, Sq, d = t[0].shape
                Hkv, Skv = t[1].shape[1], t[1].shape[2]
                ctas = decode_note(B, Hkv, Skv, dtype, d)
            elif kname == "flash_attention":
                B, H, Sq, d = t[0].shape
                ctas = (f" ctas={flash_attention.simt_ctas(B, H, Sq, d)} "
                        f"q_tile={flash_attention.simt_q_tile(d)}")
            elif kname == "flash_attention_tc":
                B, H, Sq, d = t[0].shape
                q_tile = flash_attention.tc_q_tile(d)
                ctas = f" ctas={B * H * -(-Sq // q_tile)} q_tile={q_tile}"
            name = f"{kname}/{call}/{dname}"
            rows[name] = kernel_row("hot", name, kname, fn, HOT[call],
                                    dtype, tuple(fns), (plain_tol, tol),
                                    note=ctas)
            del t
            torch.cuda.empty_cache()
    rows.update(hot_extra_rows(dev))
    return rows


def decode_note(B, Hkv, Skv, dtype, d) -> str:
    """The decode kernel's CTAs and parts of a kv group for such a call
    (``flash_attention.decode_split``): in bfloat16 a cluster of ranks of
    ``per`` keys, in float32 splits of ``per`` keys, a warp each in CTAs
    of 4 warps (and a merge kernel after them)."""
    from repro_torch.kernels import flash_attention

    parts, per = flash_attention.decode_split(B, Hkv, Skv, dtype, d)
    if dtype == torch.bfloat16:
        return f" ctas={B * Hkv * parts} cluster={parts} per={per}"
    return f" ctas={B * Hkv * -(-parts // 4)} splits={parts} per={per}"


def hot_extra_rows(dev) -> dict:
    """Phase 4's short lines (``HOT_EXTRA``, bfloat16, inputs drawn from
    their own generator of ``SEED``): each through ``ops`` with fresh
    counts, held against its plain version and the oracle, then timed
    beside PyTorch's call (``kernel_row``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ops, rmsnorm

    rng = np.random.default_rng(SEED)
    dt = torch.bfloat16

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev).to(dt)

    p = HOT_EXTRA["flash_attention_decode_qwen2"]
    q = draw(p["b"], p["h"], p["sq"], p["d"])
    k, v = (draw(p["b"], p["hkv"], p["skv"], p["d"]) for _ in range(2))
    name = "flash_decode/qwen2-0.5b_decode/bfloat16"
    rows = {name: kernel_row(
        "hot", name, "flash_decode", "flash_attention", p, dt,
        (lambda: ops.flash_attention(q, k, v, causal=False),
         lambda: flash_attention.plain(q, k, v, causal=False),
         lambda: ops.flash_attention(q, k, v, causal=False, mode="ref"),
         lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)),
        (flash_attention.PLAIN_TOL["decode", dt],
         hot_tol("flash_attention", dt, None)),
        note=decode_note(p["b"], p["hkv"], p["skv"], dt, p["d"]))}
    del q, k, v
    p = HOT_EXTRA["rmsnorm_wide"]
    x, scale = draw(p["rows"], p["d"]), draw(p["d"])
    w = (1.0 + scale).to(dt)
    name = "rmsnorm/wide_internvl2-76b/bfloat16"
    tol = hot_tol("rmsnorm", dt, None)
    rows[name] = kernel_row(
        "hot", name, "rmsnorm", "rmsnorm", p, dt,
        (lambda: ops.rmsnorm(x, scale),
         lambda: rmsnorm.rmsnorm_plain(x, scale),
         lambda: ops.rmsnorm(x, scale, mode="ref"),
         lambda: F.rms_norm(x, (p["d"],), weight=w, eps=1e-5)),
        ((tol, tol), tol),
        note=f" ctas={rmsnorm.ctas(p['rows'], p['d'], dt)} "
             f"path={rmsnorm.path(p['d'], dt)}")
    del x, scale
    torch.cuda.empty_cache()
    return rows


def launch_counters():
    """``(zero, counts)`` over every kernel of the port: ``zero()`` sets
    each launch count to 0, ``counts()`` gives the nonzero ones by name."""
    from repro_torch.core import lower_cuda
    from repro_torch.kernels import ops

    kernels = {**ops.KERNELS, **lower_cuda.KERNELS}

    def zero():
        for kern in kernels.values():
            kern.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items() if k.launches}
    return zero, counts


def flash_kernel(cfg, B, Sq, Skv, dev) -> str:
    """The ``ops.KERNELS`` name of the flash kernel that ``route`` picks
    for ``cfg``'s attention over ``B`` rows of ``Sq`` queries and ``Skv``
    keys."""
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models import attention

    plan = attention.plan_for(cfg)
    q = torch.empty(B, plan.hq_p, Sq, cfg.hd, dtype=cfg.cdtype, device=dev)
    kv = torch.empty(B, plan.hkv_p, Skv, cfg.hd, dtype=cfg.cdtype,
                     device=dev)
    return ops.ROUTES["flash_attention"][flash_attention.route(q, kv, kv)]


def attn_calls(cfg) -> int:
    """The attention calls of one prefill or decode step: one a layer of
    the attention families, one a shared-attention application of the
    hybrid (``transformer.hybrid_blocks``), none for RWKV or Mamba2
    alone."""
    from repro_torch.models import transformer as T

    if cfg.rwkv is not None or (cfg.ssm is not None and not cfg.attn_every):
        return 0
    if cfg.ssm is not None:
        _, full, tail = T.hybrid_blocks(cfg)
        return full + (tail > 0)
    return cfg.num_layers


def norm_calls(cfg) -> int:
    """The RMSNorm calls of one prefill or decode step: two a layer (a
    Mamba2 layer's input norm and gated norm), one an attention call of
    the hybrid's shared block, and the head's."""
    shared = attn_calls(cfg) if cfg.ssm is not None else 0
    return 2 * cfg.num_layers + shared + 1


def lm_expected(cfg, dev, prompt_lens, slots, steps) -> dict:
    """The launches of ``len(prompt_lens)`` prefills (B = 1, each its
    prompt) and ``steps`` decode steps of ``slots`` rows: rmsnorm
    ``norm_calls`` (2L + 1 for the attention families) and the routed
    flash kernel ``attn_calls`` (L) a call."""
    A = attn_calls(cfg)
    want = {"rmsnorm": norm_calls(cfg) * (len(prompt_lens) + steps)}
    calls = [(flash_kernel(cfg, 1, S, S, dev), 1) for S in prompt_lens]
    calls.append((flash_kernel(cfg, slots, 1, 1, dev), steps))
    for name, n in calls:
        if n and A:
            want[name] = want.get(name, 0) + A * n
    return want


def lm_serve(cfg, params, dev, label, spec, slots, max_len, policy,
             totals=None):
    """Serve ``spec``'s (prompt, max_new) requests through the port's
    ``Engine`` with every launch count set to 0 just before and read just
    after: every request finished with its tokens and each kernel
    launched exactly as ``lm_expected``; the counts are added to
    ``totals`` when given (the main path's).  Returns (engine,
    requests)."""
    from repro_torch.serve.engine import Engine

    zero, counts = launch_counters()
    V = cfg.vocab_size
    eng = Engine(cfg, params, slots=slots, max_len=max_len, policy=policy,
                 device=dev)
    reqs = [eng.submit(p, max_new=m) for p, m in spec]
    zero()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = counts()
    for i, r in enumerate(reqs):
        if not r.done or len(r.out) != r.max_new or \
                not all(0 <= x < V for x in r.out):
            raise AssertionError(f"{label}: request {i} gave {r.out} for "
                                 f"{r.max_new} tokens")
    want = lm_expected(cfg, dev, [len(p) for p, _ in spec], slots,
                       eng.stats["steps"])
    if got != want:
        raise AssertionError(f"{label}: kernels launched {got}, the path "
                             f"asks for {want}")
    if totals is not None:
        for n, c in got.items():
            totals[n] = totals.get(n, 0) + c
    toks = sum(len(r.out) for r in reqs)
    print(f"{label}: policy={policy.value} requests={len(reqs)} "
          f"slots={slots} max_len={max_len} tokens={toks} wall_s={wall} "
          f"tok_per_s={toks / wall} launches={eng.stats['launches']} "
          f"syncs={eng.stats['syncs']} steps={eng.stats['steps']} "
          f"kernels={got} card={card_line()}")
    return eng, reqs


def lm_times(fn) -> tuple[float, float | None, list]:
    """``(wall_ms, busy_ms, top)`` of ``fn()``: the host's wall with the
    card synchronised at both ends, median of ``LM_TURNS`` after one more;
    the card's busy time a call, the union of the kernels' intervals that
    ``torch.profiler`` (CUPTI) traced over ``LM_TURNS`` more calls, over
    the count (None when the trace holds no kernel); and the five kernels
    with the most device time a call, ``(name, ms)``.  An event window
    behind a spin cannot give the busy time here: a decode step enqueues
    more launches than the card's launch queue holds, so its tail is
    enqueued at the host's pace inside the window.  The trace's device
    events are read from the profiler's raw results: ``prof.events()``
    would build every host op's event tree first, minutes for a call of
    tens of thousands of ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(LM_TURNS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LM_TURNS):
            fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            a = e.start_ns() / 1e3
            b = a + e.duration_ns() / 1e3
            spans.append((a, b))
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (b - a)
    busy, reach = 0.0, None
    for a, b in sorted(spans):          # the union, in us
        if reach is None or a > reach:
            busy += b - a
            reach = b
        elif b > reach:
            busy += b - reach
            reach = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (statistics.median(walls[1:]),
            busy / LM_TURNS / 1e3 if spans else None,
            [(n[:60], t / LM_TURNS / 1e3) for n, t in top])


def lm_kernel_rows(cfg, params, prompt, rng, totals, dev, card,
                   tag="lm") -> dict:
    """Each kernel of the LM path (rmsnorm, the tc prefill, the cluster
    decode) at ``prompt``'s shapes, on its first attention's inputs
    (layer 0's, or the hybrid's shared block's), against its plain
    version, the oracle and PyTorch's call (``kernel_row``), ``launches``
    the main path's ``totals``; rmsnorm with a scale drawn from ``rng``
    (the model's starts at 0, which would leave the kernel's 1 + scale
    untested).  Returns the rows by name, ``<kernel>/<tag>_<arch>/<dtype>``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ops, rmsnorm
    from repro_torch.models import attention
    from repro_torch.models import transformer as T

    plan = attention.plan_for(cfg)
    dt = cfg.cdtype
    lp = T.layer_params(params, 0)
    ln, attn_p = ((params["shared_attn"]["ln"], params["shared_attn"]["attn"])
                  if "shared_attn" in params else (lp["ln1"], lp["attn"]))
    x = T.embed(cfg, params, {"tokens": prompt[None]})
    rows2d = x.reshape(-1, cfg.d_model).contiguous()
    xn = ops.rmsnorm(rows2d, ln).reshape(x.shape)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=dev)[None]
    q, k, v = (t.transpose(1, 2).contiguous() for t in
               attention._project_qkv(cfg, plan, attn_p, xn, pos))
    q1 = q[:, :, -1:].contiguous()
    scale = torch.from_numpy(rng.standard_normal(
        cfg.d_model, dtype=np.float32)).to(dev).to(ln.dtype)
    S, hd = x.shape[1], cfg.hd
    scale_w = (1.0 + scale).to(dt)

    def attn(qq, causal, **kw):
        return lambda: ops.flash_attention(qq, k, v, causal=causal,
                                           q_blk=qq.shape[2], kv_blk=S, **kw)

    calls = {
        "rmsnorm": (
            "rmsnorm", {"rows": S, "d": cfg.d_model},
            (lambda: ops.rmsnorm(rows2d, scale),
             lambda: rmsnorm.rmsnorm_plain(rows2d, scale),
             lambda: ops.rmsnorm(rows2d, scale, mode="ref"),
             lambda: F.rms_norm(rows2d, (cfg.d_model,), weight=scale_w,
                                eps=1e-5)),
            (2e-2, 2e-2)),
        "flash_attention_tc": (
            "flash_attention",
            {"b": 1, "h": plan.hq_p, "hkv": plan.hkv_p, "sq": S, "skv": S,
             "d": hd, "causal": True},
            (attn(q, True), attn(q, True, mode="interpret"),
             attn(q, True, mode="ref"),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True)),
            flash_attention.PLAIN_TOL["tc", dt]),
        "flash_decode": (
            "flash_attention",
            {"b": 1, "h": plan.hq_p, "hkv": plan.hkv_p, "sq": 1, "skv": S,
             "d": hd, "causal": False},
            (attn(q1, False), attn(q1, False, mode="interpret"),
             attn(q1, False, mode="ref"),
             lambda: F.scaled_dot_product_attention(q1, k, v,
                                                    enable_gqa=True)),
            flash_attention.PLAIN_TOL["decode", dt])}
    out = {}
    for kname, (fn, p, fns, plain_tol) in calls.items():
        name = f"{kname}/{tag}_{cfg.name}/{str(dt).removeprefix('torch.')}"
        note = (decode_note(1, p["hkv"], p["skv"], dt, p["d"])
                if kname == "flash_decode" else "")
        out[name] = kernel_row(f"{tag} kernel", name, kname, fn, p, dt, fns,
                               (plain_tol, hot_tol(fn, dt, None)),
                               launches=totals[kname],
                               note=f"{note} card={card}")
    del q, k, v, q1, x, rows2d, xn, scale
    return out


def forced_check(cfg, prm, toks, max_len, steps, tol, label, card):
    """A prefill of ``toks`` and ``steps`` decode steps through the
    kernels and through their plain versions on the card
    (``mode="interpret"``), both fed the plain versions' greedy tokens:
    every step's logits finite, of the plain versions' shape and within
    ``tol`` max-abs of theirs, and the greedy tokens equal wherever the
    plain versions' top-1 / top-2 margin exceeds ``tol``.  Returns the
    plain versions' greedy stream, the first step with a row under the
    margin (or None) and the gaps."""
    from repro_torch.models import transformer as T

    V = cfg.vocab_size

    def greedy(logits):
        return logits[:, -1, :V].argmax(-1)[:, None]

    want, wc = T.prefill(cfg, prm, {"tokens": toks}, max_len,
                         mode="interpret")
    got, gc = T.prefill(cfg, prm, {"tokens": toks}, max_len)
    gaps, under, first_under, stream, top = [], 0, None, [], 0.0
    for j in range(steps + 1):
        if j:
            want, wc = T.decode_step(cfg, prm, wc, nxt, mode="interpret")
            got, gc = T.decode_step(cfg, prm, gc, nxt)
        if not (torch.isfinite(got).all() and got.shape == want.shape):
            raise AssertionError(f"{label}: step {j} gave "
                                 f"{tuple(got.shape)} or non-finite")
        gaps.append(float((got - want).abs().max()))
        top = max(top, float(want.abs().max()))
        ref = want[:, -1, :V]
        top2 = ref.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > tol
        agree = greedy(got)[:, 0] == ref.argmax(-1)
        if not bool(agree[clear].all()):
            raise AssertionError(f"{label}: step {j}'s token differs above "
                                 f"the margin")
        if not bool(clear.all()) and first_under is None:
            first_under = j
        under += int((~clear).sum())
        nxt = greedy(want)
        stream.append(nxt[:, 0].tolist())
    print(f"{label}: batch={toks.shape[0]} prompt={toks.shape[1]} "
          f"steps={steps + 1} gaps={gaps} max_gap={max(gaps)} tol={tol} "
          f"logit_max={top} under_margin={under} "
          f"first_under={first_under} card={card}")
    if max(gaps) > tol:
        raise AssertionError(f"{label}: logits {max(gaps)} from the plain "
                             f"versions' > {tol}")
    return stream, first_under, gaps


def lm_phase(dev) -> dict:
    """Phase 5: the LM serving path at qwen2-0.5b's full width through the
    port's ``Engine`` (the main path: each serving run with every launch
    count set to 0 just before and read just after; rmsnorm 2L + 1 times
    and the routed flash kernel L times a prefill and a decode step, and
    no other kernel), the model's logits against its plain versions on the
    card (teacher-forced), the path's timings, and each of its kernels at
    the long prompt's shapes against its plain version and the oracle.
    Returns the kernels' JSON rows by name."""
    from repro_torch.configs import registry
    from repro_torch.core.streams import Policy
    from repro_torch.models import attention
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    card = card_line()
    cfg = registry.get(LM_ARCH)
    plan = attention.plan_for(cfg)
    L, dt, V = cfg.num_layers, cfg.cdtype, cfg.vocab_size
    t0 = time.perf_counter()
    params = T.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    print(f"lm model {cfg.name}: layers={L} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} padded="
          f"{plan.hq_p}/{plan.hkv_p} head_dim={cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={V} padded_vocab={cfg.padded_vocab} dtype={cfg.param_dtype} "
          f"tied={cfg.tie_embeddings} qkv_bias={cfg.qkv_bias} "
          f"params={sum(t.numel() for t in leaves(params))} init_s={init_s}")

    rng = np.random.default_rng(SEED)
    tr = LM_TRAFFIC
    prompts = [rng.integers(0, V, tr["prompt_len"])
               for _ in range(tr["requests"])]
    long_prompt = rng.integers(0, V, LM_LONG["prompt_len"])
    if flash_kernel(cfg, 1, tr["prompt_len"], tr["prompt_len"], dev) != \
            "flash_attention_tc" or \
            flash_kernel(cfg, 1, 1, 1, dev) != "flash_decode":
        raise AssertionError("lm: the path would not take the tc prefill "
                             "and cluster decode kernels")

    totals = {}

    def serve(label, spec, slots, max_len, policy, main=True):
        return lm_serve(cfg, params, dev, f"lm serve {label}", spec, slots,
                        max_len, policy, totals if main else None)

    # the main path: the serve command's traffic under both policies, then
    # the long prompt (a short warm-up first, its counts not kept)
    cli_len = tr["prompt_len"] + tr["max_new"] + 8
    serve("warm-up", [(prompts[0], 2)], 1, cli_len, Policy.HAZARD_ONLY,
          main=False)
    outs = {}
    for policy in (Policy.HAZARD_ONLY, Policy.SYNC_ALWAYS):
        _, reqs = serve("traffic", [(p, tr["max_new"]) for p in prompts],
                        tr["slots"], cli_len, policy)
        outs[policy] = [r.out for r in reqs]
    if outs[Policy.HAZARD_ONLY] != outs[Policy.SYNC_ALWAYS]:
        raise AssertionError("lm serve: the two policies gave other tokens")
    long_len = LM_LONG["prompt_len"] + LM_LONG["max_new"] + 8
    _, (long_req,) = serve("long", [(long_prompt, LM_LONG["max_new"])], 1,
                           long_len, Policy.HAZARD_ONLY)

    def greedy(logits):
        return logits[:, -1, :V].argmax(-1)[:, None]

    # the logits against the plain versions on the card, teacher-forced
    # with the plain versions' greedy tokens
    def forced(label, prm, toks, max_len, steps):
        return forced_check(cfg, prm, toks, max_len, steps, LM_TOL,
                            f"lm check {label}", card)

    # the traffic on the served weights and on LM_CHECK_SEEDS' others
    batch = torch.from_numpy(np.stack(prompts[:tr["slots"]])).to(dev)
    for seed in LM_CHECK_SEEDS:
        prm = params if seed == SEED else T.init_params(cfg, seed, device=dev)
        forced(f"traffic seed={seed}", prm, batch, cli_len, tr["max_new"] - 1)
        del prm
    long_toks = torch.from_numpy(long_prompt[None]).to(dev)
    stream, first_under, _ = forced(f"long seed={SEED}", params, long_toks,
                                    long_len, LM_LONG["max_new"] - 1)
    plain_toks = [t[0] for t in stream]
    agree = first_under if first_under is not None else len(plain_toks)
    if long_req.out[:agree] != plain_toks[:agree]:
        raise AssertionError(f"lm serve long: tokens {long_req.out} part "
                             f"from the plain versions' {plain_toks} before "
                             f"the first step under the margin ({agree})")
    print(f"lm serve long: the served tokens equal the plain versions' "
          f"greedy ones over the first {agree} of {len(plain_toks)} "
          f"(the rest after a step under the margin: "
          f"{long_req.out[agree:] == plain_toks[agree:]})")
    # and against the kernel path's own greedy loop at the engine's shapes
    # (B = 1, the same max_len): the same kernels, so every token equal
    lg, c = T.prefill(cfg, params, {"tokens": long_toks}, long_len)
    free = []
    for j in range(LM_LONG["max_new"]):
        if j:
            lg, c = T.decode_step(cfg, params, c, nxt)
        nxt = greedy(lg)
        free.append(int(nxt[0, 0]))
    if long_req.out != free:
        raise AssertionError(f"lm serve long: tokens {long_req.out} differ "
                             f"from the kernel path's greedy loop {free}")
    print(f"lm serve long: the served tokens equal the kernel path's greedy "
          f"loop's over all {len(free)}")
    del lg, c

    # timings: a prefill at both prompt lengths (one request, as the engine
    # admits it) and a decode step of the traffic's slots
    def timing(label, fn, tokens):
        wall, busy, top = lm_times(fn)
        idle = "not measured" if busy is None else 1 - busy / wall
        print(f"lm {label}: wall_ms={wall} device_busy_ms={busy} "
              f"idle_share={idle} tok_per_s={tokens / wall * 1e3} "
              f"top_kernels_ms={top} card={card}")

    for S, toks in ((tr["prompt_len"], prompts[0]),
                    (LM_LONG["prompt_len"], long_prompt)):
        t = torch.from_numpy(toks[None]).to(dev)
        timing(f"prefill S={S}", lambda t=t, S=S: T.prefill(
            cfg, params, {"tokens": t}, S + 40), S)
    _, cache = T.prefill(cfg, params, {"tokens": batch}, cli_len)
    nxt = batch[:, -1:]
    timing(f"decode slots={tr['slots']} pos={cache['pos']}",
           lambda: T.decode_step(cfg, params, cache, nxt), tr["slots"])
    del cache

    # each kernel of the path at the long prompt's shapes, on its layer-0
    # inputs, against its plain version, the oracle and PyTorch's call
    out = lm_kernel_rows(cfg, params, long_prompt, rng, totals, dev, card)
    if set(totals) != {"rmsnorm", "flash_attention_tc", "flash_decode"}:
        raise AssertionError(f"lm: the main path launched {totals}")
    del params
    torch.cuda.empty_cache()
    print(f"phase 5: seconds={time.perf_counter() - t_phase} card={card}")
    return out


def train_phase(dev) -> dict:
    """Phase 6: the LM training path at qwen2-0.5b's full width and depth
    through the port's train step (the main path: one step with every
    launch count set to 0 just before and read just after; rmsnorm 2L + 1
    times a forward and 2L more in remat's recompute, flash_attention_tc
    L times a forward and L more in the recompute, no other kernel), the
    step against the same step through the plain versions on two seeds'
    weights, each flash route's lse against its plain version (serving's
    output bit for bit without it), loss falling over a repeated batch,
    ``launch.train`` for 3 steps, the step's timings and the trainable
    flash beside SDPA.  Returns the kernels' JSON rows by name."""
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention, ops, rmsnorm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_mod

    t_phase = time.perf_counter()
    card = card_line()
    cfg = registry.get(LM_ARCH)
    if cfg.remat != "full" or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"train: {cfg.name} is not bfloat16 under "
                             f"remat full")
    L, dt, S = cfg.num_layers, cfg.cdtype, TRAIN_SEQ
    plan = attention.plan_for(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    opt_cfg = adamw.AdamWConfig(total_steps=100, warmup_steps=5,
                                schedule=cfg.schedule,
                                state_dtype=cfg.opt_state_dtype)
    zero, counts = launch_counters()
    per_step = {"rmsnorm": 2 * (2 * L) + 1, "flash_attention_tc": 2 * L}

    def data(seed):
        return SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                           seed=seed).batch_at(0)

    def worst(a, b):
        """The leaf whose ||a - b|| / ||b|| is largest, and that ratio."""
        out = ("", 0.0)
        for (name, x), y in zip(flat(a), adamw.tree_leaves(b)):
            r = float((x.float() - y.float()).norm()
                      / y.float().norm().clamp(min=1e-30))
            out = max(out, (name, r), key=lambda t: t[1])
        return out

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k],
                                                          f"{path}/{k}")]
        return [(path, tree)]

    # the main path: one train step with fresh counts
    params = T.init_params(cfg, SEED, device=dev)
    opt = adamw.init_state(opt_cfg, params)
    batch = data(SEED)
    step = train_mod.make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = time.perf_counter()
    p1, o1, m = step(params, opt, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    totals = counts()
    peak = torch.cuda.max_memory_allocated()
    if totals != per_step:
        raise AssertionError(f"train: the step launched {totals}, the path "
                             f"asks for {per_step}")
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
            and all(bool(torch.isfinite(x).all())
                    for x in adamw.tree_leaves(p1)) and int(o1.step) == 1):
        raise AssertionError("train: the step gave a non-finite result")
    nparams = sum(x.numel() for x in adamw.tree_leaves(params))
    print(f"train main {cfg.name}: layers={L} d_model={cfg.d_model} "
          f"heads={plan.hq_p}/{plan.hkv_p} padded_vocab={cfg.padded_vocab} "
          f"params={nparams} dtype={cfg.param_dtype} remat={cfg.remat} "
          f"state_dtype={opt_cfg.state_dtype} batch={TRAIN_BATCH}x{S} "
          f"loss={float(m['loss'])} grad_norm={float(m['grad_norm'])} "
          f"lr={float(m['lr'])} launches={totals} first_step_s={first_s} "
          f"max_memory_allocated_bytes={peak} card={card}")
    del p1, o1, m

    # the step against its plain versions, on two seeds' weights
    for seed in TRAIN_CHECK_SEEDS:
        prm = params if seed == SEED else T.init_params(cfg, seed,
                                                        device=dev)
        b = data(seed)
        res = {}
        for mode in (None, "interpret"):
            (l, _), g = train_mod.value_and_grad(
                train_mod.make_loss(cfg, mode=mode), prm, b)
            newp, _, om = adamw.apply_updates(
                opt_cfg, prm, g, adamw.init_state(opt_cfg, prm))
            res[mode] = (float(l), g, newp, float(om["grad_norm"]))
        (lk, gk, pk, nk), (lp, gp, pp, np_) = res[None], res["interpret"]
        gaps = {"loss": abs(lk - lp) / abs(lp),
                "grad_norm": abs(nk - np_) / np_}
        gname, gaps["grad"] = worst(gk, gp)
        pname, gaps["param"] = worst(pk, pp)
        print(f"train check seed={seed}: loss={lk} plain_loss={lp} "
              f"grad_norm={nk} plain_grad_norm={np_} gaps={gaps} "
              f"worst_grad_leaf={gname} worst_param_leaf={pname} "
              f"tol={TRAIN_TOL} card={card}")
        for what, tol in TRAIN_TOL.items():
            if not gaps[what] <= tol:
                raise AssertionError(f"train check seed={seed}: {what} "
                                     f"{gaps[what]} from the plain step's "
                                     f"> {tol}")
        del prm, res, gk, gp, pk, pp
        torch.cuda.empty_cache()

    # each flash route's lse against its plain version, at phase 4's
    # shapes and the training shape; the output with lse bit for bit the
    # output without
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    hd = cfg.hd
    shapes = [(f"{call}/{str(d).removeprefix('torch.')}", HOT[call], d)
              for call in ("flash_attention_prefill",
                           "flash_attention_decode") for d in HOT_DTYPES]
    shapes.append(("train/bfloat16", {
        "b": TRAIN_BATCH, "h": plan.hq_p, "hkv": plan.hkv_p, "sq": S,
        "skv": S, "d": hd, "causal": True}, dt))
    for label, p, d in shapes:
        q = draw(p["b"], p["h"], p["sq"], p["d"], dtype=d)
        k = draw(p["b"], p["hkv"], p["skv"], p["d"], dtype=d)
        v = draw(p["b"], p["hkv"], p["skv"], p["d"], dtype=d)
        kw = dict(causal=p["causal"], q_blk=p["sq"], kv_blk=p["skv"])
        route = flash_attention.route(q, k, v)
        out_l, lse = flash_attention.flash_attention(q, k, v, with_lse=True,
                                                     **kw)
        out = flash_attention.flash_attention(q, k, v, **kw)
        plain_out, plain_lse = flash_attention.plain(q, k, v, with_lse=True,
                                                     **kw)
        gap = float((lse - plain_lse).abs().max())
        rtol, atol = flash_attention.PLAIN_TOL[route, d]
        ok = (torch.equal(out_l, out) and gap <= LSE_TOL
              and torch.allclose(out.float(), plain_out.float(), rtol=rtol,
                                 atol=atol))
        bits = "equal" if torch.equal(out_l, out) else "differ"
        print(f"train lse {label}: route={route} lse_gap={gap} "
              f"tol={LSE_TOL} out_bits={bits} card={card}")
        if not ok:
            raise AssertionError(f"train lse {label}: the {route} kernel's "
                                 f"lse or output disagrees")
        del q, k, v, out_l, out, lse, plain_out, plain_lse
    torch.cuda.empty_cache()

    # the loss falls over a repeated batch (test_overfit_tiny_batch)
    fit_cfg = adamw.AdamWConfig(lr_peak=1e-3, total_steps=30, warmup_steps=1,
                                state_dtype=cfg.opt_state_dtype)
    fit = train_mod.make_train_step(cfg, fit_cfg)
    prm, st, losses = params, adamw.init_state(fit_cfg, params), []
    for _ in range(OVERFIT_STEPS):
        prm, st, mm = fit(prm, st, batch)
        losses.append(float(mm["loss"]))
    print(f"train overfit: losses={losses} card={card}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train overfit: the loss did not fall "
                             f"{losses}")
    del prm, st, mm

    # timings: a train step (host wall, the card synchronised at both
    # ends; busy time and the costliest kernels from torch.profiler)
    wall, busy, top = lm_times(lambda: step(params, opt, batch))
    idle = "not measured" if busy is None else 1 - busy / wall
    print(f"train step: wall_ms={wall} device_busy_ms={busy} "
          f"idle_share={idle} tok_per_s={tokens / wall * 1e3} "
          f"top_kernels_ms={top} card={card}")

    # the trainable flash at the training shape, forward and backward,
    # beside SDPA's (TF32 off)
    q = draw(TRAIN_BATCH, plan.hq_p, S, hd, dtype=dt).requires_grad_()
    k = draw(TRAIN_BATCH, plan.hkv_p, S, hd, dtype=dt).requires_grad_()
    v = draw(TRAIN_BATCH, plan.hkv_p, S, hd, dtype=dt).requires_grad_()
    dout = draw(TRAIN_BATCH, plan.hq_p, S, hd, dtype=dt)

    def ours():
        out = attention.attend_heads(q, k, v, causal=True,
                                     q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk)
        return torch.autograd.grad(out, (q, k, v), dout)

    def sdpa():
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, (q, k, v), dout)

    with torch.no_grad():
        fwd_ms = time_ms(lambda: flash_attention.flash_attention(
            q, k, v, causal=True, q_blk=S, kv_blk=S, with_lse=True))
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    both_ms, sdpa_both_ms = time_ms(ours), time_ms(sdpa)
    print(f"train flash: shape={tuple(q.shape)}/{tuple(k.shape)} "
          f"fwd_ms={fwd_ms} fwd_bwd_ms={both_ms} bwd_ms={both_ms - fwd_ms} "
          f"sdpa_fwd_ms={sdpa_fwd_ms} sdpa_fwd_bwd_ms={sdpa_both_ms} "
          f"sdpa_bwd_ms={sdpa_both_ms - sdpa_fwd_ms} card={card}")

    # each kernel of the path at the training shapes against its plain
    # version, the oracle and PyTorch's call; rmsnorm on the batch's
    # embedded rows with a drawn scale
    x = T.embed(cfg, params, batch).reshape(-1, cfg.d_model).contiguous()
    scale = draw(cfg.d_model, dtype=torch.float32)
    scale_w = (1.0 + scale).to(dt)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    calls = {
        "rmsnorm": (
            "rmsnorm", {"rows": tokens, "d": cfg.d_model},
            (lambda: ops.rmsnorm(x, scale),
             lambda: rmsnorm.rmsnorm_plain(x, scale),
             lambda: ops.rmsnorm(x, scale, mode="ref"),
             lambda: F.rms_norm(x, (cfg.d_model,), weight=scale_w,
                                eps=1e-5)),
            (2e-2, 2e-2)),
        "flash_attention_tc": (
            "flash_attention",
            {"b": TRAIN_BATCH, "h": plan.hq_p, "hkv": plan.hkv_p, "sq": S,
             "skv": S, "d": hd, "causal": True},
            (lambda: ops.flash_attention(qd, kd, vd, q_blk=S, kv_blk=S),
             lambda: ops.flash_attention(qd, kd, vd, q_blk=S, kv_blk=S,
                                         mode="interpret"),
             lambda: ops.flash_attention(qd, kd, vd, mode="ref"),
             lambda: F.scaled_dot_product_attention(
                 qd, kd, vd, is_causal=True, enable_gqa=True)),
            flash_attention.PLAIN_TOL["tc", dt])}
    rows = {}
    for kname, (fn, p, fns, plain_tol) in calls.items():
        name = f"{kname}/lm_train_{LM_ARCH}/{str(dt).removeprefix('torch.')}"
        rows[name] = kernel_row("train kernel", name, kname, fn, p, dt, fns,
                                (plain_tol, hot_tol(fn, dt, None)),
                                launches=totals[kname], note=f" card={card}")
    del params, opt, q, k, v, dout, qd, kd, vd, x
    torch.cuda.empty_cache()

    # the entry point: launch.train for 3 steps on the card
    zero()
    t0 = time.perf_counter()
    loss = launch_train.main(["--arch", LM_ARCH, "--steps", "3", "--batch",
                              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
    torch.cuda.synchronize()
    run = counts()
    want = {n: 3 * c for n, c in per_step.items()}
    print(f"train launch: loss={loss} wall_s={time.perf_counter() - t0} "
          f"launches={run} card={card}")
    if run != want or not np.isfinite(loss):
        raise AssertionError(f"train launch: launched {run} (the path asks "
                             f"for {want}), loss {loss}")
    torch.cuda.empty_cache()
    print(f"phase 6: seconds={time.perf_counter() - t_phase} card={card}")
    return rows


def param_bytes(tree) -> tuple[int, int]:
    """(elements, bytes) of every leaf of a parameter tree."""
    n = b = 0
    for v in tree.values():
        if isinstance(v, dict):
            dn, db = param_bytes(v)
        else:
            dn, db = v.numel(), v.numel() * v.element_size()
        n, b = n + dn, b + db
    return n, b


def lm_init(cfg, seed, dev, label, card):
    """``init_params`` on the card, timed, with its peak memory above
    what was allocated before it, held to the parameters' bytes plus one
    layer's and one float32 draw of the largest leaf (the layers are
    drawn one at a time into a stack allocated once; two stacks would
    exceed it).  Returns the parameters."""
    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n, nbytes = param_bytes(params)
    L = cfg.num_layers
    layer = param_bytes(params["layers"])[1] // L
    draw = 4 * max([v.numel() for v in params.values()
                    if not isinstance(v, dict)]
                   + [v.numel() for v in params["embed"].values()]
                   + [t.numel() // L for t in layer_leaves(params["layers"])])
    limit = nbytes + layer + draw
    print(f"{label} init {cfg.name} seed={seed}: layers={L} params={n} "
          f"param_bytes={nbytes} init_s={init_s} init_peak_bytes={peak} "
          f"peak_over_params={peak / nbytes} limit_bytes={limit} "
          f"card={card}")
    if peak > limit:
        raise AssertionError(f"{label}: the init's peak {peak} is above "
                             f"{limit}, the parameters' bytes and one "
                             f"layer's draws")
    return params


def layer_leaves(tree):
    for v in tree.values():
        yield from layer_leaves(v) if isinstance(v, dict) else (v,)


def moe_routing(idx, C: int, dispatch: str, E: int):
    """``(one_hot [G, gs, k, E], chosen [G, gs, E], kept [G, gs, E])`` of
    top indices ``idx`` by the dispatch's rule: einsum serves every first
    choice before any second one, sort token by token; a choice is kept
    when fewer than C choices are queued on its expert before it."""
    import torch.nn.functional as F

    G, gs, k = idx.shape
    oh = F.one_hot(idx, E)
    if dispatch == "sort":
        flat = oh.reshape(G, gs * k, E)
        pos = (torch.cumsum(flat, 1) - flat).reshape(G, gs, k, E)
    else:
        pos = torch.empty_like(oh)
        running = torch.zeros((G, 1, E), dtype=oh.dtype, device=oh.device)
        for j in range(k):
            ohj = oh[:, :, j]
            pos[:, :, j] = running + torch.cumsum(ohj, 1) - ohj
            running = running + ohj.sum(1, keepdim=True)
    chosen = (oh > 0).any(2)
    kept = ((pos < C) & (oh > 0)).any(2)
    return oh, chosen, kept


def moe_routing_check(cfg, params, toks, label, card) -> dict:
    """Phase 7 (b): each layer run from the plain path's input to it
    (``mode="interpret"``, layer by layer) through the kernels and through
    the plain versions, both paths' routing recorded by wrapping
    ``moe._route``.  Passes when (1) the tokens that both route alike
    (the same experts, each kept or dropped alike) are within
    MOE_LAYER_TOL; (2) every token whose experts differ has a plain
    margin between its k-th and (k+1)-th gate no larger than twice the
    largest difference of one of its gates between the paths (one gate
    rises, another falls, each by at most that); (3) every token kept on
    one path and dropped on the other sits in an expert whose queue a
    token with other choices changed.  Prints the share of flipped
    (layer, token) pairs, the end-to-end logit gap and the share of
    positions whose greedy token is the same: printed, not gated."""
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as T
    from repro_torch.models.common import dense

    m = cfg.moe
    E, k, D = m.num_experts, m.top_k, cfg.d_model
    plan = attention.plan_for(cfg)
    seen = []
    real = moe._route

    def route(c, p, xt, **kw):
        out = real(c, p, xt, **kw)
        gates = torch.softmax(dense(xt, p["router"],
                                    compute_dtype=torch.float32), dim=-1)
        seen.append((gates, out[1]))
        return out

    gaps, flipped, kept_changed, worst_margin = [], 0, 0, 0.0
    moe._route = route
    try:
        x = T.embed(cfg, params, {"tokens": toks})
        pos = T._positions(x)
        ntok = x.shape[0] * x.shape[1]
        _, C = moe.group_of(m, ntok)
        for i in range(cfg.num_layers):
            lp = T.layer_params(params, i)
            seen.clear()
            yp, _, _ = T._layer_full(cfg, plan, lp, x, pos, "interpret")
            yk, _, _ = T._layer_full(cfg, plan, lp, x, pos, None)
            (gp, ip), (gk, ik) = seen
            ohp, chp, kpp = moe_routing(ip, C, m.dispatch, E)
            ohk, chk, kpk = moe_routing(ik, C, m.dispatch, E)
            same_set = (chp == chk).all(-1)
            agree = same_set & (kpp == kpk).all(-1)
            diff = (yk.float() - yp.float()).abs().reshape(-1, D).amax(-1)
            gaps.append(float(diff[agree.reshape(-1)].max()))
            # (2) a flipped token's plain margin against its gates' move
            top = gp.sort(-1, descending=True).values
            margin = top[..., k - 1] - top[..., k]
            move = (gk - gp).abs().amax(-1)
            flip = ~same_set
            if bool((flip & (margin > 2 * move)).any()):
                raise AssertionError(f"{label}: layer {i}: a token changed "
                                     f"experts with a plain margin above "
                                     f"its gates' move")
            if bool(flip.any()):
                worst_margin = max(worst_margin,
                                   float((margin / move)[flip].max()))
            # (3) a kept status changed only in a queue a choice changed
            queue = (ohp != ohk).any(2).any(1)                 # [G, E]
            moved = (kpp != kpk) & chp & chk
            if bool((moved & ~queue[:, None, :]).any()):
                raise AssertionError(f"{label}: layer {i}: a token's kept "
                                     f"status changed in an expert no "
                                     f"flipped token touched")
            flipped += int(flip.sum())
            kept_changed += int(moved.any(-1).sum())
            x = yp
        seen.clear()
        plain = T.head(cfg, params, x, mode="interpret")
        mine, _ = T.forward(cfg, params, {"tokens": toks})
    finally:
        moe._route = real
    V = cfg.vocab_size
    e2e = float((mine - plain).abs().max())
    same = float((mine[..., :V].argmax(-1) == plain[..., :V].argmax(-1))
                 .float().mean())
    share = flipped / (cfg.num_layers * ntok)
    print(f"{label}: layers={cfg.num_layers} tokens={ntok} capacity={C} "
          f"dispatch={m.dispatch} layer_gaps={gaps} max_gap={max(gaps)} "
          f"tol={MOE_LAYER_TOL} flipped_pairs={flipped} "
          f"flipped_share={share} kept_changed={kept_changed} "
          f"worst_margin_over_move={worst_margin} e2e_logit_gap={e2e} "
          f"greedy_same_share={same} card={card}")
    if max(gaps) > MOE_LAYER_TOL:
        raise AssertionError(f"{label}: a layer's tokens routed alike are "
                             f"{max(gaps)} from the plain versions' > "
                             f"{MOE_LAYER_TOL}")
    del plain, mine, x
    return {"max_gap": max(gaps), "flipped_share": share}


def moe_train_check(cfg, dev, card) -> None:
    """Phase 7 (d): a train step of ``cfg`` at full width, its depth cut
    to MOE_TRAIN_LAYERS (``train_check``): each step launches rmsnorm
    4L + 1 and flash_attention_tc 2L times (remat full) and no other
    kernel, and the aux term is finite."""
    cfg = cfg.replace(num_layers=MOE_TRAIN_LAYERS)
    L = cfg.num_layers
    train_check(cfg, {"rmsnorm": 4 * L + 1, "flash_attention_tc": 2 * L},
                "moe train", dev, card)


def train_check(cfg, per_step, label, dev, card) -> None:
    """A train step of ``cfg`` under remat full, AdamW with the config's
    float32 moments, a batch of TRAIN_BATCH x TRAIN_SEQ tokens from
    SyntheticLM: each of OVERFIT_STEPS steps on the one batch at lr 1e-3
    with every launch count set to 0 just before and read just after
    launches ``per_step`` and no other kernel, the aux term is finite,
    and the loss falls."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_mod

    L = cfg.num_layers
    if cfg.remat != "full":
        raise AssertionError(f"{label}: {cfg.name} is not under remat full")
    zero, counts = launch_counters()
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, total_steps=30, warmup_steps=1,
                                state_dtype=cfg.opt_state_dtype)
    params = lm_init(cfg, SEED, dev, label, card)
    opt = adamw.init_state(opt_cfg, params)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=SEED).batch_at(0)
    step = train_mod.make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, auxes, walls = [], [], []
    for i in range(OVERFIT_STEPS):
        zero()
        t0 = time.perf_counter()
        params, opt, mm = step(params, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = counts()
        if got != per_step:
            raise AssertionError(f"{label}: step {i} launched {got}, the "
                                 f"path asks for {per_step}")
        losses.append(float(mm["loss"]))
        auxes.append(float(mm["aux"]))
    wall = statistics.median(walls[1:])
    print(f"{label} {cfg.name}: layers={L} batch={TRAIN_BATCH}x"
          f"{TRAIN_SEQ} state_dtype={opt_cfg.state_dtype} launches={per_step} "
          f"losses={losses} aux={auxes} step_walls_s={walls} "
          f"tok_per_s={TRAIN_BATCH * TRAIN_SEQ / wall} "
          f"max_memory_allocated_bytes={torch.cuda.max_memory_allocated()} "
          f"card={card}")
    if not all(np.isfinite(auxes)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: aux {auxes}, losses {losses}: "
                             f"not finite or not falling")
    del params, opt, mm
    torch.cuda.empty_cache()


def av_check(dev, card) -> None:
    """Phase 7 (e): the audio config (``[B, S, K]`` tokens) at full width
    and depth and the VLM config (1,024 patch embeddings in front of the
    tokens) at full width, VLM_LAYERS deep, on each of AV_CHECK_SEEDS'
    weights: a prefill and AV_STEPS decode steps through the kernels,
    each with every launch count set to 0 just before and read just
    after (rmsnorm 2L + 1 and the routed flash kernel L, no other), held
    to the same calls through the plain versions, teacher-forced with the
    plain versions' greedy tokens, within AV_TOL."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T

    zero, counts = launch_counters()
    for arch, layers in ((AUDIO_ARCH, None), (VLM_ARCH, VLM_LAYERS)):
        cfg = registry.get(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        L, V, K, P = (cfg.num_layers, cfg.vocab_size, cfg.num_codebooks,
                      cfg.patch_prefix)
        B = LM_TRAFFIC["slots"] if K > 1 else 1
        S = AV_SEQ + P
        max_len = S + AV_STEPS + 8

        def greedy(logits):
            nxt = logits[:, -1:, ..., :V].argmax(-1)
            return nxt                   # [B, 1] or [B, 1, K]

        def kernels(fn, want):
            zero()
            out = fn()
            torch.cuda.synchronize()
            if counts() != want:
                raise AssertionError(f"av {cfg.name}: launched {counts()}, "
                                     f"the path asks for {want}")
            return out

        for seed in AV_CHECK_SEEDS:
            params = lm_init(cfg, seed, dev, "av", card)
            rng = np.random.default_rng(seed)
            shape = (B, AV_SEQ, K) if K > 1 else (B, AV_SEQ)
            batch = {"tokens": torch.from_numpy(
                rng.integers(0, V, shape)).to(dev)}
            if P:
                batch["patch_embeds"] = (torch.from_numpy(rng.standard_normal(
                    (B, P, cfg.d_model), dtype=np.float32)) * 0.02).to(dev)
            want, wc = T.prefill(cfg, params, batch, max_len,
                                 mode="interpret")
            got, gc_ = kernels(
                lambda: T.prefill(cfg, params, batch, max_len),
                {"rmsnorm": 2 * L + 1,
                 flash_kernel(cfg, B, S, S, dev): L})
            gaps, top = [float((got - want).abs().max())], 0.0
            for _ in range(AV_STEPS):
                nxt = greedy(want)
                want, wc = T.decode_step(cfg, params, wc, nxt,
                                         mode="interpret")
                got, gc_ = kernels(
                    lambda: T.decode_step(cfg, params, gc_, nxt),
                    {"rmsnorm": 2 * L + 1,
                     flash_kernel(cfg, B, 1, 1, dev): L})
                if not (torch.isfinite(got).all() and
                        got.shape == want.shape):
                    raise AssertionError(f"av {cfg.name}: a decode step "
                                         f"gave {tuple(got.shape)} or "
                                         f"non-finite logits")
                gaps.append(float((got - want).abs().max()))
                top = max(top, float(want.abs().max()))
            print(f"av check {cfg.name} seed={seed}: layers={L} batch={B} "
                  f"prompt={AV_SEQ} patches={P} codebooks={K} "
                  f"logits={tuple(got.shape)} steps={AV_STEPS + 1} "
                  f"gaps={gaps} max_gap={max(gaps)} tol={AV_TOL[arch]} "
                  f"logit_max={top} card={card}")
            if max(gaps) > AV_TOL[arch]:
                raise AssertionError(f"av {cfg.name}: logits {max(gaps)} "
                                     f"from the plain versions' > "
                                     f"{AV_TOL[arch]}")
            del params, want, wc, got, gc_, batch
            torch.cuda.empty_cache()


def moe_phase(dev) -> dict:
    """Phase 7: the mixture-of-experts decoder at deepseek-moe-16b's full
    width and depth through the port's ``Engine`` (phase 5's traffic and
    long prompt, each run with every launch count set to 0 just before
    and read just after: rmsnorm 2L + 1 and the routed flash kernel L a
    prefill and a decode step, no other kernel), the served long request
    against the kernel path's greedy loop, the timings; (f) each kernel at
    the long prompt's shapes (d = 128, 16 heads; D = 2048); (c) the sort
    dispatch's prefill twice, bit for bit; (b) the routing-aware check of
    the kernels against their plain versions on two seeds' weights; (d) a
    train step at 2 layers; (e) the audio and VLM configs.  Returns the
    kernels' JSON rows by name."""
    import dataclasses
    import gc

    from repro_torch.configs import registry
    from repro_torch.core.streams import Policy
    from repro_torch.models import attention
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    card = card_line()
    cfg = registry.get(MOE_ARCH)
    m, L, V = cfg.moe, cfg.num_layers, cfg.vocab_size
    plan = attention.plan_for(cfg)
    print(f"moe model {cfg.name}: layers={L} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} padded={plan.hq_p}/"
          f"{plan.hkv_p} head_dim={cfg.hd} experts={m.num_experts} "
          f"top_k={m.top_k} expert_d_ff={m.expert_d_ff} shared="
          f"{m.num_shared}x{m.shared_d_ff} capacity_factor="
          f"{m.capacity_factor} group_size={m.group_size} dispatch="
          f"{m.dispatch} vocab={V} dtype={cfg.param_dtype} "
          f"allocated_before_bytes={torch.cuda.memory_allocated()} "
          f"card={card}")
    params = lm_init(cfg, SEED, dev, "moe", card)

    rng = np.random.default_rng(SEED)
    tr = LM_TRAFFIC
    prompts = [rng.integers(0, V, tr["prompt_len"])
               for _ in range(tr["requests"])]
    long_prompt = rng.integers(0, V, LM_LONG["prompt_len"])
    if flash_kernel(cfg, 1, tr["prompt_len"], tr["prompt_len"], dev) != \
            "flash_attention_tc" or \
            flash_kernel(cfg, 1, 1, 1, dev) != "flash_decode":
        raise AssertionError("moe: the path would not take the tc prefill "
                             "and cluster decode kernels")

    # (a) the main path: phase 5's traffic under both policies, then the
    # long prompt (a short warm-up first, its counts not kept)
    totals = {}
    cli_len = tr["prompt_len"] + tr["max_new"] + 8
    lm_serve(cfg, params, dev, "moe serve warm-up", [(prompts[0], 2)], 1,
             cli_len, Policy.HAZARD_ONLY)
    torch.cuda.reset_peak_memory_stats()
    outs = {}
    for policy in (Policy.HAZARD_ONLY, Policy.SYNC_ALWAYS):
        _, reqs = lm_serve(cfg, params, dev, "moe serve traffic",
                           [(p, tr["max_new"]) for p in prompts],
                           tr["slots"], cli_len, policy, totals)
        outs[policy] = [r.out for r in reqs]
    if outs[Policy.HAZARD_ONLY] != outs[Policy.SYNC_ALWAYS]:
        raise AssertionError("moe serve: the two policies gave other tokens")
    long_len = LM_LONG["prompt_len"] + LM_LONG["max_new"] + 8
    _, (long_req,) = lm_serve(cfg, params, dev, "moe serve long",
                              [(long_prompt, LM_LONG["max_new"])], 1,
                              long_len, Policy.HAZARD_ONLY, totals)
    print(f"moe serve peak: max_memory_allocated_bytes="
          f"{torch.cuda.max_memory_allocated()} card={card}")

    # the served long request against the kernel path's own greedy loop
    # at the engine's shapes (B = 1, the same max_len)
    long_toks = torch.from_numpy(long_prompt[None]).to(dev)
    lg, c = T.prefill(cfg, params, {"tokens": long_toks}, long_len)
    free = []
    for j in range(LM_LONG["max_new"]):
        if j:
            lg, c = T.decode_step(cfg, params, c, nxt)
        nxt = lg[:, -1, :V].argmax(-1)[:, None]
        free.append(int(nxt[0, 0]))
    if long_req.out != free:
        raise AssertionError(f"moe serve long: tokens {long_req.out} differ "
                             f"from the kernel path's greedy loop {free}")
    print(f"moe serve long: the served tokens equal the kernel path's "
          f"greedy loop's over all {len(free)}")
    del lg, c

    # timings: a prefill at both prompt lengths (one request, as the
    # engine admits it) and a decode step of the traffic's slots
    def timing(label, fn, tokens):
        wall, busy, top = lm_times(fn)
        idle = "not measured" if busy is None else 1 - busy / wall
        print(f"moe {label}: wall_ms={wall} device_busy_ms={busy} "
              f"idle_share={idle} tok_per_s={tokens / wall * 1e3} "
              f"top_kernels_ms={top} card={card}")

    for S, toks in ((tr["prompt_len"], prompts[0]),
                    (LM_LONG["prompt_len"], long_prompt)):
        t = torch.from_numpy(toks[None]).to(dev)
        timing(f"prefill S={S}", lambda t=t, S=S: T.prefill(
            cfg, params, {"tokens": t}, S + 40), S)
    batch = torch.from_numpy(np.stack(prompts[:tr["slots"]])).to(dev)
    _, cache = T.prefill(cfg, params, {"tokens": batch}, cli_len)
    nxt = batch[:, -1:]
    timing(f"decode slots={tr['slots']} pos={cache['pos']}",
           lambda: T.decode_step(cfg, params, cache, nxt), tr["slots"])
    del cache

    # (f) each kernel at the long prompt's shapes: d = 128 with 16 heads,
    # D = 2048
    rows = lm_kernel_rows(cfg, params, long_prompt, rng, totals, dev, card)
    if set(totals) != {"rmsnorm", "flash_attention_tc", "flash_decode"}:
        raise AssertionError(f"moe: the main path launched {totals}")

    # (c) the sort dispatch: the long prompt's prefill twice, bit for bit
    zero, counts = launch_counters()
    sort_cfg = cfg.replace(moe=dataclasses.replace(m, dispatch="sort"))
    runs = []
    for _ in range(2):
        zero()
        lg, c = T.prefill(sort_cfg, params, {"tokens": long_toks}, long_len)
        torch.cuda.synchronize()
        want = lm_expected(cfg, dev, [LM_LONG["prompt_len"]], 1, 0)
        if counts() != want:
            raise AssertionError(f"moe sort: launched {counts()}, the path "
                                 f"asks for {want}")
        runs.append((lg, c["k"], c["v"]))
    same = all(torch.equal(a, b) for a, b in zip(*runs, strict=True))
    print(f"moe sort: prefill S={LM_LONG['prompt_len']} twice: bits "
          f"{'equal' if same else 'differ'} launches={want} card={card}")
    if not same:
        raise AssertionError("moe sort: two prefills gave other bits")
    del runs, lg, c

    # (b) the routing-aware check on MOE_CHECK_SEEDS' weights
    for seed in MOE_CHECK_SEEDS:
        if seed != SEED:
            del params
            gc.collect()
            torch.cuda.empty_cache()
            params = lm_init(cfg, seed, dev, "moe check", card)
        moe_routing_check(cfg, params, long_toks, f"moe check seed={seed}",
                          card)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a train step at full width, 2 layers deep; (e) audio and VLM
    moe_train_check(cfg, dev, card)
    av_check(dev, card)
    print(f"phase 7: seconds={time.perf_counter() - t_phase} card={card}")
    return rows


def ssm_model_line(cfg, card) -> str:
    """The phase 8 model's shape, for its ``ssm model`` line."""
    from repro_torch.models import mamba2, rwkv6

    A = attn_calls(cfg)
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner, H, conv_ch, _ = mamba2.dims(cfg)
        mixer = (f"mamba2 d_inner={d_inner} ssm_heads={H}x{s.head_dim} "
                 f"state={s.state_dim} chunk={s.chunk} conv={s.conv_dim} "
                 f"attn_every={cfg.attn_every} shared_attn_calls={A} "
                 f"heads={cfg.num_heads}/{cfg.num_kv_heads} "
                 f"head_dim={cfg.hd}")
    else:
        H, hd = rwkv6.rdims(cfg)
        mixer = (f"rwkv6 heads={H}x{hd} d_ff={cfg.d_ff} "
                 f"decay_lora={cfg.rwkv.decay_lora} chunk={cfg.rwkv.chunk}")
    return (f"ssm model {cfg.name}: layers={cfg.num_layers} "
            f"d_model={cfg.d_model} {mixer} vocab={cfg.vocab_size} "
            f"dtype={cfg.param_dtype} "
            f"allocated_before_bytes={torch.cuda.memory_allocated()} "
            f"card={card}")


def consistency_check(cfg, params, dev, label, card, B=2, S=16, Sp=12):
    """tests/test_models.py's ``_consistency`` through the kernels: a
    prefill of ``Sp`` tokens and teacher-forced decode steps to ``S``,
    their logits against forward's over the ``S`` tokens.  Returns the
    gaps."""
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    full, _ = T.forward(cfg, params, {"tokens": toks})
    lg, cache = T.prefill(cfg, params, {"tokens": toks[:, :Sp]}, S)
    gaps = [float((lg[:, 0] - full[:, Sp - 1]).abs().max())]
    for j in range(Sp, S):
        lg, cache = T.decode_step(cfg, params, cache, toks[:, j:j + 1])
        gaps.append(float((lg[:, 0] - full[:, j]).abs().max()))
    tol = SSM_CONSISTENCY_TOL[cfg.name]
    print(f"{label}: consistency batch={B} prompt={Sp} steps={S - Sp} "
          f"gaps={gaps} max_gap={max(gaps)} tol={tol} "
          f"logit_max={float(full.abs().max())} card={card}")
    if max(gaps) > tol:
        raise AssertionError(f"{label}: prefill and decode {max(gaps)} from "
                             f"forward's logits > {tol}")
    return gaps


def gated_norm_row(cfg, params, prompt, rng, totals, card) -> dict:
    """Phase 8 (e): rmsnorm in float32 on Mamba2's gated norm at the long
    prompt's shape (``[S, d_inner]``, rows wider than the kernel's
    register path's 2,304 floats: its wide path, a CTA a row), on layer
    0's own input to it and a scale drawn from ``rng``, against its plain
    version, the oracle and ``F.rms_norm`` (``kernel_row``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, rmsnorm
    from repro_torch.models import mamba2
    from repro_torch.models import transformer as T

    lp = T.layer_params(params, 0)
    grab = {}
    real = mamba2._gate_out

    def gate_out(c, p, y, z, mode):
        grab["y"] = (y * mamba2.silu(z.float())).reshape(-1, y.shape[-1])
        return real(c, p, y, z, mode)

    x = T.embed(cfg, params, {"tokens": prompt[None]})
    mamba2._gate_out = gate_out
    try:
        mamba2.mamba_full(cfg, lp["mamba"], ops.rmsnorm(
            x.reshape(-1, cfg.d_model).contiguous(),
            lp["ln1"]).reshape(x.shape))
    finally:
        mamba2._gate_out = real
    y = grab.pop("y").contiguous()
    rows, d = y.shape
    scale = torch.from_numpy(rng.standard_normal(d, dtype=np.float32)).to(
        y.device)
    w = 1.0 + scale
    name = f"rmsnorm/ssm_{cfg.name}_gated/float32"
    tol = hot_tol("rmsnorm", torch.float32, None)
    return {name: kernel_row(
        "ssm kernel", name, "rmsnorm", "rmsnorm", {"rows": rows, "d": d},
        torch.float32,
        (lambda: ops.rmsnorm(y, scale), lambda: rmsnorm.rmsnorm_plain(y, scale),
         lambda: ops.rmsnorm(y, scale, mode="ref"),
         lambda: F.rms_norm(y, (d,), weight=w, eps=1e-5)),
        ((tol, tol), tol), launches=totals["rmsnorm"],
        note=f" path={rmsnorm.path(d, torch.float32)} "
             f"ctas={rmsnorm.ctas(rows, d, torch.float32)} card={card}")}


def ssm_serve_check(arch, dev, card) -> dict:
    """Phase 8 (a) / (b), (c) and (e) for ``arch`` at full width and
    depth.  Returns its kernels' JSON rows by name."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.core.streams import Policy
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    cfg = registry.get(arch)
    V, A = cfg.vocab_size, attn_calls(cfg)
    print(ssm_model_line(cfg, card))
    params = lm_init(cfg, SEED, dev, "ssm", card)
    rng = np.random.default_rng(SEED)
    tr = LM_TRAFFIC
    prompts = [rng.integers(0, V, tr["prompt_len"])
               for _ in range(tr["requests"])]
    long_prompt = rng.integers(0, V, LM_LONG["prompt_len"])
    if A and (flash_kernel(cfg, 1, tr["prompt_len"], tr["prompt_len"],
                           dev) != "flash_attention_tc"
              or flash_kernel(cfg, 1, 1, 1, dev) != "flash_decode"):
        raise AssertionError("ssm: the shared attention would not take the "
                             "tc prefill and cluster decode kernels")

    # the main path: phase 5's traffic under both policies, then the long
    # prompt (a short warm-up first, its counts not kept)
    totals = {}
    cli_len = tr["prompt_len"] + tr["max_new"] + 8
    lm_serve(cfg, params, dev, f"ssm serve warm-up {arch}",
             [(prompts[0], 2)], 1,
             cli_len, Policy.HAZARD_ONLY)
    torch.cuda.reset_peak_memory_stats()
    outs = {}
    for policy in (Policy.HAZARD_ONLY, Policy.SYNC_ALWAYS):
        _, reqs = lm_serve(cfg, params, dev, f"ssm serve traffic {arch}",
                           [(p, tr["max_new"]) for p in prompts],
                           tr["slots"], cli_len, policy, totals)
        outs[policy] = [r.out for r in reqs]
    if outs[Policy.HAZARD_ONLY] != outs[Policy.SYNC_ALWAYS]:
        raise AssertionError("ssm serve: the two policies gave other tokens")
    long_len = LM_LONG["prompt_len"] + LM_LONG["max_new"] + 8
    _, (long_req,) = lm_serve(cfg, params, dev, f"ssm serve long {arch}",
                              [(long_prompt, LM_LONG["max_new"])], 1,
                              long_len, Policy.HAZARD_ONLY, totals)
    want = {"rmsnorm"} | ({"flash_attention_tc", "flash_decode"} if A
                          else set())
    if set(totals) != want:
        raise AssertionError(f"ssm {arch}: the main path launched {totals}")
    print(f"ssm serve peak {arch}: max_memory_allocated_bytes="
          f"{torch.cuda.max_memory_allocated()} launches={totals} "
          f"card={card}")

    # the served long request against the kernel path's own greedy loop
    # at the engine's shapes (B = 1, the same max_len)
    long_toks = torch.from_numpy(long_prompt[None]).to(dev)
    lg, c = T.prefill(cfg, params, {"tokens": long_toks}, long_len)
    free = []
    for j in range(LM_LONG["max_new"]):
        if j:
            lg, c = T.decode_step(cfg, params, c, nxt)
        nxt = lg[:, -1, :V].argmax(-1)[:, None]
        free.append(int(nxt[0, 0]))
    if long_req.out != free:
        raise AssertionError(f"ssm serve long: tokens {long_req.out} differ "
                             f"from the kernel path's greedy loop {free}")
    print(f"ssm serve long {arch}: the served tokens equal the kernel "
          f"path's greedy loop's over all {len(free)}")
    del lg, c

    # timings: a prefill at both prompt lengths (one request, as the
    # engine admits it) and a decode step of the traffic's slots
    def timing(label, fn, tokens):
        wall, busy, top = lm_times(fn)
        idle = "not measured" if busy is None else 1 - busy / wall
        print(f"ssm {label} {arch}: wall_ms={wall} device_busy_ms={busy} "
              f"idle_share={idle} tok_per_s={tokens / wall * 1e3} "
              f"top_kernels_ms={top} card={card}")

    for S, toks in ((tr["prompt_len"], prompts[0]),
                    (LM_LONG["prompt_len"], long_prompt)):
        t = torch.from_numpy(toks[None]).to(dev)
        timing(f"prefill S={S}", lambda t=t, S=S: T.prefill(
            cfg, params, {"tokens": t}, S + 40), S)
    batch = torch.from_numpy(np.stack(prompts[:tr["slots"]])).to(dev)
    _, cache = T.prefill(cfg, params, {"tokens": batch}, cli_len)
    nxt = batch[:, -1:]
    timing(f"decode slots={tr['slots']} pos={cache['pos']}",
           lambda: T.decode_step(cfg, params, cache, nxt), tr["slots"])
    del cache

    # (e) the kernels at the model's shapes: the shared attention's
    # (d = 112, 32 heads) over the long prompt, rmsnorm at d_model in
    # bfloat16 and at d_inner in float32
    rows = {}
    if A:
        rows.update(lm_kernel_rows(cfg, params, long_prompt, rng, totals,
                                   dev, card, tag="ssm"))
        rows.update(gated_norm_row(cfg, params, long_prompt, rng, totals,
                                   card))

    # (c) the traffic's prompts teacher-forced against the plain versions,
    # and prefill then decode against forward, on SSM_CHECK_SEEDS' weights
    for seed in SSM_CHECK_SEEDS:
        if seed != SEED:
            del params
            gc.collect()
            torch.cuda.empty_cache()
            params = lm_init(cfg, seed, dev, "ssm check", card)
        label = f"ssm check {arch} seed={seed}"
        forced_check(cfg, params, batch, cli_len, tr["max_new"] - 1,
                     SSM_TOL[arch], label, card)
        consistency_check(cfg, params, dev, label, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def ssm_phase(dev) -> dict:
    """Phase 8: the state-space mixers at full width and depth through
    the port's ``Engine`` (zamba2-7b, rwkv6-1.6b: ``ssm_serve_check``),
    their train steps (``train_check``) and their kernels' rows.  Returns
    the kernels' JSON rows by name."""
    from repro_torch.configs import registry

    t_phase = time.perf_counter()
    card = card_line()
    rows = {}
    for arch in SSM_ARCHS:
        rows.update(ssm_serve_check(arch, dev, card))
    # (d) a train step at full width: zamba2-7b SSM_TRAIN_LAYERS deep
    # (each mamba layer and each shared attention recomputed once),
    # rwkv6-1.6b at full depth
    for arch in SSM_ARCHS:
        cfg = registry.get(arch).replace(num_layers=SSM_TRAIN_LAYERS[arch])
        L, A = cfg.num_layers, attn_calls(cfg)
        per_step = {"rmsnorm": 2 * norm_calls(cfg) - 1}
        if A:
            per_step["flash_attention_tc"] = 2 * A
        train_check(cfg, per_step, "ssm train", dev, card)
    seconds = time.perf_counter() - t_phase
    print(f"phase 8: seconds={seconds} ceiling_s={SSM_CEILING_S} "
          f"card={card}")
    return rows


#: phase 9's ceiling (s), printed beside its seconds
MESH_CEILING_S = 60.0
#: phase 9 (c): timed compressed_psum calls over the step's gradient tree
PSUM_RUNS = 5
#: phase 9 (c): a dequantized leaf's distance from its gradient, over its
#: scale: a half step, widened by the float32 rounding of ``g / scale``
#: as ``tests/test_property.py::test_quantize_bounded`` widens it
PSUM_BOUND = 0.5 * 1.001
#: phase 9 (f): the dry-run cell run in a child process
DRYRUN_CELL = ("qwen2-0.5b", "decode_32k")


def tree_bytes(tree) -> int:
    """Bytes of every tensor of nested dicts / tuples (a named tuple's
    fields too)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    return 0


def mesh_phase(dev) -> None:
    """Phase 9: the mesh path on the card.  (a) a process group of one
    rank (NCCL, a file store in a temporary directory) and a ``1x1``
    ``(data, model)`` mesh; (b) phase 6's train step (qwen2-0.5b at full
    width and depth, 4 x 1,024 tokens, ``SEED``) under ``use_mesh`` with
    ``shard_params`` - every launch count set to 0 just before and read
    just after: rmsnorm 4L + 1 and flash_attention_tc 2L, no other kernel
    - its loss, parameters and moments bit for bit the same step without
    a mesh (or within the gap of two runs without one, printed, where
    those differ); (c) ``compressed_psum`` over the group on the step's
    gradients: each leaf's dequantized sum within ``PSUM_BOUND`` scales of
    the gradient (float32, before the cast to the gradient's dtype, which
    the reduced leaf equals bit for bit), the error feedback bit for bit
    the residual rounded once, timed with CUDA events; (d) the parameters
    saved without a mesh and restored onto it, bit for bit; (e) the cost
    analysis of the same step on meta tensors: its argument bytes equal
    the card's parameter, optimizer and batch bytes, its predicted peak
    and bound step time beside the card's peak and wall; (f) one dry-run
    cell (``DRYRUN_CELL`` on the 16x16 fake mesh) in a child process.  The
    phase's seconds beside ``MESH_CEILING_S``."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_mod

    t_phase = time.perf_counter()
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="mesh_phase_")
    # (a) a group of one rank and a 1x1 mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = shd.make_mesh((1, 1), ("data", "model"), device="cuda")
        cfg = registry.get(LM_ARCH)
        L = cfg.num_layers
        opt_cfg = adamw.AdamWConfig(total_steps=100, warmup_steps=5,
                                    schedule=cfg.schedule,
                                    state_dtype=cfg.opt_state_dtype)
        per_step = {"rmsnorm": 4 * L + 1, "flash_attention_tc": 2 * L}
        zero, counts = launch_counters()
        batch = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                            seed=SEED).batch_at(0)
        params = T.init_params(cfg, SEED, device=dev)
        opt = adamw.init_state(opt_cfg, params)
        step = train_mod.make_train_step(cfg, opt_cfg)

        def leaves(p, o):
            return adamw.tree_leaves(p) + adamw.tree_leaves(o.m) + \
                adamw.tree_leaves(o.v)

        # (b) two steps without a mesh, then the step under the mesh
        plain = [step(params, opt, batch) for _ in range(2)]
        gap = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
            leaves(*plain[0][:2]), leaves(*plain[1][:2]), strict=True))
        gap = max(gap, abs(float(plain[0][2]["loss"])
                           - float(plain[1][2]["loss"])))
        with shd.use_mesh(mesh):
            ps = shd.shard_params(params, mesh)
            os_ = shd.shard_params(opt, mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            t0 = time.perf_counter()
            p2, o2, m2 = step(ps, os_, batch)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            totals = counts()
            peak = torch.cuda.max_memory_allocated()
        if totals != per_step:
            raise AssertionError(f"mesh: the step launched {totals}, the "
                                 f"path asks for {per_step}")
        p1, o1, m1 = plain[0]
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(leaves(p1, o1), leaves(p2, o2), strict=True))
        diff = max(diff, abs(float(m1["loss"]) - float(m2["loss"])))
        print(f"mesh main {cfg.name}: mesh=1x1 (data, model) group=nccl/1 "
              f"batch={TRAIN_BATCH}x{TRAIN_SEQ} loss={float(m2['loss'])} "
              f"plain_loss={float(m1['loss'])} max_diff={diff} "
              f"gap_of_two_plain_runs={gap} launches={totals} "
              f"wall_s={wall_s} max_memory_allocated_bytes={peak} "
              f"card={card}")
        if diff > gap:
            raise AssertionError(f"mesh: the step under the 1x1 mesh is "
                                 f"{diff} from the step without it, two "
                                 f"steps without it {gap}")
        del plain, p2, o2, os_, ps
        torch.cuda.empty_cache()

        # (c) compressed_psum over the group on the step's gradients
        _, grads = train_mod.value_and_grad(train_mod.make_loss(cfg),
                                            params, batch)
        red, err = compression.compressed_psum(grads, dist.group.WORLD)
        worst, nbytes = 0.0, 0
        for g, r, e in zip(adamw.tree_leaves(grads), adamw.tree_leaves(red),
                           adamw.tree_leaves(err), strict=True):
            # one rank: the group's scale is the leaf's own, the sum q
            gf = g.float()
            q, scale = compression.quantize(gf)
            resid = (gf.double() - q.double() * scale.double()).float()
            if not torch.equal(e, resid):
                raise AssertionError("mesh psum: the error feedback is not "
                                     "the residual's bits")
            if not torch.equal(r, (q.to(torch.int32).float() * scale
                                   / 1).to(g.dtype)):
                raise AssertionError("mesh psum: the reduced leaf is not "
                                     "its dequantized sum's bits")
            off = float((compression.dequantize(q, scale) - gf).abs().max())
            if not off <= PSUM_BOUND * float(scale):
                raise AssertionError(f"mesh psum: a leaf's dequantized sum "
                                     f"lies {off} from its gradient, beyond "
                                     f"{PSUM_BOUND} x scale")
            worst = max(worst, off / float(scale))
            nbytes += g.numel() * g.element_size()
        times = []
        for _ in range(PSUM_RUNS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            compression.compressed_psum(grads, dist.group.WORLD, err)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        comp, full = compression.dcn_bytes(grads)
        print(f"mesh psum: leaves={len(adamw.tree_leaves(grads))} "
              f"grad_bytes={nbytes} int8_bytes={comp} fp32_bytes={full} "
              f"worst_err_over_scale={worst} "
              f"ms={statistics.median(times[1:])} card={card}")
        del grads, red, err

        # (d) saved without a mesh, restored onto it
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(1, params, blocking=True)
        restored, _ = mgr.restore(params, mesh=mesh)
        if not all(torch.equal(a, b) for a, b in zip(
                adamw.tree_leaves(params), adamw.tree_leaves(restored),
                strict=True)):
            raise AssertionError("mesh: the restore onto the mesh is not "
                                 "the saved parameters bit for bit")
        print(f"mesh restore: leaves={len(adamw.tree_leaves(params))} "
              f"bytes={tree_bytes(params)} bits=equal card={card}")
        del restored

        # (e) the cost analysis of the same step on meta tensors
        card_args = tree_bytes(params) + tree_bytes(opt) + tree_bytes(batch)
        meta_p = T.abstract_params(cfg)
        meta_b = {"tokens": torch.empty(TRAIN_BATCH, TRAIN_SEQ,
                                        dtype=torch.int32, device="meta")}
        phases = dryrun.train_phases(cfg, opt_cfg, meta_p,
                                     adamw.init_state(opt_cfg, meta_p),
                                     meta_b)
        costs, mem = dryrun.run_phases(phases, None, None, 1)
        if mem["argument_bytes"] != card_args:
            raise AssertionError(f"mesh analysis: argument bytes "
                                 f"{mem['argument_bytes']} against the "
                                 f"card's {card_args}")
        bound_s = max(costs.flops / dryrun.PEAK_FLOPS,
                      costs.bytes / dryrun.HBM_BW)
        print(f"mesh analysis {cfg.name}: argument_bytes="
              f"{mem['argument_bytes']} card_argument_bytes={card_args} "
              f"flops={costs.flops} bytes={costs.bytes} "
              f"predicted_peak_bytes={mem['peak_bytes']} "
              f"card_peak_bytes={peak} bound_step_s={bound_s} "
              f"card_wall_s={wall_s} (derived from counts and datasheet "
              f"peaks) card={card}")
        del params, opt
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (f) one dry-run cell on the 16x16 fake mesh, in a child process
    arch, shape = DRYRUN_CELL
    out = os.path.join(tmp, "dryrun")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=300)
    cell_s = time.perf_counter() - t0
    path = os.path.join(out, f"{arch}_{shape}_16x16.json")
    if r.returncode != 0 or not os.path.exists(path):
        raise AssertionError(f"mesh dryrun: exit {r.returncode} "
                             f"{r.stderr[-2000:]}")
    with open(path) as f:
        rec = json.load(f)
    if rec["status"] != "ok":
        raise AssertionError(f"mesh dryrun: {rec.get('error')}")
    print(f"mesh dryrun {arch} {shape} 16x16: status={rec['status']} "
          f"seconds={cell_s} peak_per_chip_gb="
          f"{rec['memory']['peak_per_chip_gb']} dominant="
          f"{rec['roofline']['dominant']} replicated_work="
          f"{rec['replicated_work']} (derived)")
    seconds = time.perf_counter() - t_phase
    print(f"phase 9: seconds={seconds} ceiling_s={MESH_CEILING_S} "
          f"card={card}")


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
    backends (``benchmarks/torch_coverage.py``'s sweep) and the shard
    check (:func:`shard_check`).  Raises on any disagreement, on a passing
    ``cuda`` cell whose entry's kernels did not each launch, on a
    ``vector`` or ``shard_vector`` cell that launched a kernel, on a
    ``shard_vector`` host cell not bit for bit ``vector``'s, on a suite
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
    cells, legs, bad, anchors = [], {}, [], {}
    seconds = dict.fromkeys(CONFORMANCE_BACKENDS, 0.0)
    t_phase = time.perf_counter()
    for backend in CONFORMANCE_BACKENDS:
        for case in cases:
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = conformance.run_matrix([case], (backend,), variants=True,
                                         device=dev, anchors=anchors)
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
    held = [c for c in cells if c.backend == "shard_vector"
            and c.mode == "host"]
    if not held or not all(c.anchor == "vector" and c.bit_identical
                           for c in held):
        raise AssertionError(
            "conformance shard_vector: host cells not bit for bit vector: "
            + "; ".join(c.label() for c in held
                        if not (c.anchor == "vector" and c.bit_identical)))
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
    shard_check(dev, cuda_suite, lower_cuda, counts)
    print(f"phase 3c: seconds={time.perf_counter() - t_phase} "
          f"shard_vector_bit_cells={len(held)}")


def shard_check(dev, cuda_suite, lower_cuda, counts) -> None:
    """The end of phase 3c: the shard backends' pool on CUDA tensors is
    the machine's cards; ``devices=2`` on the card's heap raises (no shard
    runs on the CPU in silence); at ``devices=1`` ``shard_vector`` gives
    ``vector``'s bits and ``shard`` ``loop``'s on a vecadd of a few blocks,
    launching no hand-written kernel."""
    from repro_torch.core import api, lower_shard

    n, block = 4 * 128, 128
    grid = n // block
    pool = lower_shard.resolve_devices(None, grid, dev)
    print(f"shard pool: cuda devices={pool} "
          f"torch.cuda.device_count={torch.cuda.device_count()}")
    rng = np.random.default_rng(SEED)
    host = {k: rng.standard_normal(n).astype(np.float32) for k in "ab"}
    host["c"] = np.zeros(n, np.float32)
    kernel = cuda_suite.make_vecadd(n)

    def run(backend, **kw):
        bufs = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        out = api.launch(kernel, grid=grid, block=block, args=bufs,
                         backend=backend, **kw)
        return {k: to_numpy(v) for k, v in out.items()}

    try:
        run("shard_vector", devices=pool + 1)
    except ValueError as e:
        print(f"shard devices={pool + 1}: refused ({str(e)[:80]}...)")
    else:
        raise AssertionError(f"shard_vector at devices={pool + 1} on the "
                             f"card's heap ran")
    before = counts()
    for backend, inner in (("shard_vector", "vector"), ("shard", "loop")):
        want, got = run(inner), run(backend, devices=1)
        same = all(got[k].tobytes() == want[k].tobytes() for k in want)
        print(f"shard {backend} devices=1: grid={grid} bits="
              f"{'equal' if same else 'DIFFER'} (against {inner})")
        if not same:
            raise AssertionError(f"{backend} at devices=1 differs from "
                                 f"{inner} on the card")
    ran = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    if ran:
        raise AssertionError(f"shard check launched kernels: {ran}")


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
            elif kname == "nn_reduce":
                n_ctas = lower_cuda.nn_reduce_ctas(grid.x, block.x)
                per = lower_cuda.nn_reduce_cta_threads()
                ctas = f" ctas={n_ctas} ({per} threads each)"
            elif kname == "nn_select":
                ctas = f" ctas={grid.x} (32 threads each)"
            elif kname == "kmeans_update":
                n_ctas = lower_cuda.kmeans_update_ctas(params["k"])
                ctas = (f" ctas={n_ctas} (a lane a cluster, up to "
                        f"{lower_cuda.kmeans_update_cta_threads()} each)")
            elif kname == "reverse":
                ctas = (f" ctas=1 ({lower_cuda.reverse_cta_threads()} "
                        f"threads)")
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
    nan_leg(ents["nn"], host_args["nn"], cuda_suite, lower_cuda, dev)

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

    # ---- phase 5: the LM serving path at qwen2-0.5b's full width -------
    rows.update(lm_phase(dev))

    # ---- phase 6: the LM training path at qwen2-0.5b's full width ------
    rows.update(train_phase(dev))

    # ---- phase 7: the MoE decoder at deepseek-moe-16b's full size -------
    rows.update(moe_phase(dev))

    # ---- phase 8: the state-space mixers at full width and depth --------
    rows.update(ssm_phase(dev))

    # ---- phase 9: the mesh path: a 1x1 mesh, compression, the dry run --
    mesh_phase(dev)

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
