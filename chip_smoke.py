#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the ``nvcc`` build
   of ``src/repro_torch/csrc/*.cu`` into ``build/repro_torch/``;
2. per hand-written kernel: one launch at the main path's shape through
   the kernel and through its plain PyTorch version on the same inputs on
   the card, compared (exactly for the int32 kernels, to 1e-4 for
   hotspot), then both timed with CUDA events, the median of 25 runs
   after warm-up.  ``ms`` is the kernel alone (its written buffers
   restored between runs, outside the timed window); ``call_ms`` adds the
   wrapper's functional copy of the written buffers; ``bound_ms`` is the
   least time the card could take for the launch's bytes and operations;
3. the main path: the four Rodinia chains at Rodinia 3.1's run-script
   sizes through ``run_entry(entry, backend="cuda")`` - chevron/api/
   backends/``lower_cuda`` - with every launch count set to 0 just before
   and read just after, each checked against the port's NumPy oracle;
   then needle_nw's host time per launch, layer by layer;
4. the kernels' JSON line, the card line, and last
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
REPLACES = "src/repro/core/pallas_emit.py:34"
SLEEP_CYCLES = 1_000_000         # keeps the card busy while a run enqueues
RUNS, WARMUP = 25, 3

#: Rodinia 3.1 run-script sizes (inputs generated from SEED)
SIZES = {
    "bfs_frontier": {"n": 1_000_000, "deg": 6},          # graph1MW_6
    "pathfinder": {"cols": 100_000, "rows": 100},        # 100000 100 20
    "needle_nw": {"n": 2048, "penalty": 10},             # needle 2048 10
    "hotspot": {"h": 1024, "w": 1024, "iters": 20},      # temp_1024
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
    s = SIZES
    return {
        "bfs_frontier": cuda_suite.entry_bfs_frontier(**s["bfs_frontier"]),
        "pathfinder": cuda_suite.entry_pathfinder(**s["pathfinder"]),
        "needle_nw": cuda_suite.entry_needle_nw(**s["needle_nw"]),
        "hotspot": cuda_suite.entry_hotspot(**s["hotspot"]),
    }


def launch_inputs(name: str, args: dict, cuda_suite, dev) -> dict:
    """One launch's buffers on the card, at a state the main path reaches.

    BFS takes the level with the widest frontier (the state before its
    expansion is fixed by the distances alone); nw its longest diagonal;
    pathfinder and hotspot their chain's first launch.
    """
    args = dict(args)
    if name == "bfs_frontier":
        n = SIZES[name]["n"]
        dist = cuda_suite.bfs_levels(args["edges"], n)
        level = int(np.bincount(dist[dist >= 0]).argmax())
        args.update(
            frontier=(dist == level).astype(np.int32),
            visited=((dist >= 0) & (dist <= level)).astype(np.int32),
            dist=np.where(dist <= level, dist, -1).astype(np.int32),
            level=np.full(1, level, np.int32))
    elif name == "needle_nw":
        args["diag"] = np.full(1, SIZES[name]["n"] + 1, np.int32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in args.items()}


def bound(name: str, b: dict, p: dict) -> tuple[float, str]:
    """Least time (ms) the card could take for one launch: every byte the
    launch needs read once and every byte it writes written once, over
    the memory rate, against its float32 operations over the peak rate."""
    i4, ops = 4, 0.0
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
    else:
        cells = p["h"] * p["w"]
        nbytes = i4 * 3 * cells                 # t, p in; t_out out
        ops = 15.0 * cells                      # flops per cell
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes"
    return ops_ms, "operations"


def compare(name: str, got: dict, want: dict, writes) -> float:
    """Max abs error of the kernel against its plain version; raises when
    they disagree (exact for int32, 1e-4 for hotspot's float32)."""
    err = 0.0
    for k in writes:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {k} is {g.dtype}{tuple(g.shape)}"
                                 f", plain gives {w.dtype}{tuple(w.shape)}")
        if g.dtype == torch.float32:
            if not (torch.isfinite(g).all()
                    and torch.allclose(g, w, rtol=1e-4, atol=1e-4)):
                raise AssertionError(f"{name}: {k} disagrees with plain")
        elif not torch.equal(g, w):
            raise AssertionError(f"{name}: {k} differs from plain")
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def check_and_time(name, kern, b, params, grid, block) -> dict:
    got = kern(b, grid=grid, block=block, **params)
    want = kern.plain(b, grid, block, **params)
    torch.cuda.synchronize()
    err = compare(name, got, want, kern.writes)
    pristine = {k: b[k].clone() for k in kern.writes}
    work = {**b, **{k: v.clone() for k, v in pristine.items()}}

    def restore():
        for k, v in pristine.items():
            work[k].copy_(v)

    ms = time_ms(lambda: kern.launch_into(work, grid, block, **params),
                 before=restore)
    call_ms = time_ms(lambda: kern(b, grid=grid, block=block, **params))
    plain_ms = time_ms(lambda: kern.plain(b, grid, block, **params))
    bound_ms, bound_by = bound(name, b, params)
    return {"name": name, "route": "cuda", "source": kern.source,
            "replaces": REPLACES, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "call_ms": call_ms}


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
    card = card_line()
    print(f"card: {card}")
    lib = _native.library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.2f} s "
          f"(nvcc, sm_90a, {len(_native.sources())} sources)")
    for line in lib.log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    ents = entries(cuda_suite)
    host_args = {n: e.make_args(rng) for n, e in ents.items()}

    # ---- phase 2: each kernel against its plain version, and timed ------
    rows = {}
    for name, entry in ents.items():
        kern = lower_cuda.KERNELS[name]
        step = entry.chain.steps[0]
        grid, block = Dim3.of(step.grid), Dim3.of(step.block)
        params = dict(step.kernel.native.params)
        b = launch_inputs(name, host_args[name], cuda_suite, dev)
        rows[name] = r = check_and_time(name, kern, b, params, grid, block)
        print(f"kernel {name}: kernel_ms={r['ms']} call_ms={r['call_ms']} "
              f"plain_ms={r['plain_ms']} bound_ms={r['bound_ms']} "
              f"({r['bound_by']}) max_abs_err={r['max_abs_err']}")
        del b
    torch.cuda.synchronize()

    # ---- phase 3: the main path at Rodinia sizes ------------------------
    wants = {n: e.reference(host_args[n]) for n, e in ents.items()}
    stats = {n: cuda_suite.ChainStats() for n in ents}
    walls = {}
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0
    for name, entry in ents.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = cuda_suite.run_entry(entry, "cuda", args=host_args[name],
                                      with_reference=False, device=dev,
                                      chain_stats=stats[name])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        for k, v in wants[name].items():
            got = out[k].cpu().numpy()
            if got.shape != v.shape or not np.isfinite(got).all() or \
                    not np.allclose(got, v, rtol=entry.tol, atol=entry.tol):
                raise AssertionError(f"{name}: {k} disagrees with the "
                                     f"oracle")
            if v.dtype.kind == "i" and not np.array_equal(got, v):
                raise AssertionError(f"{name}: {k} not bit-identical")
    launches = {n: k.launches for n, k in lower_cuda.KERNELS.items()}
    for name in ents:
        ran = launches[name]
        if ran == 0 or ran != stats[name].launches:
            raise AssertionError(f"{name}: kernel counted {ran} launches, "
                                 f"chain ran {stats[name].launches}")
        rows[name]["launches"] = ran
        print(f"main {name}: {SIZES[name]} wall_s={walls[name]} "
              f"launches={ran} us_per_launch={walls[name] / ran * 1e6} "
              f"oracle=match")

    nw = "needle_nw"
    layers = layer_us(ents[nw], host_args[nw], dev, api, carry,
                      lower_cuda.KERNELS[nw])
    layers["chain_us"] = walls[nw] / launches[nw] * 1e6
    print(f"layers {nw}: " + " ".join(f"{k}={v}" for k, v in layers.items()))

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
