#!/usr/bin/env python3
"""Split the main path's vecadd wall into its parts on one CUDA card.

    PYTHONPATH=src python tools/vecadd_wall.py [--turns 7] [--label NAME]

``chip_smoke.py``'s phase 3 times ``cuda_suite.run_entry`` for vecadd at
n = 2^24 (three float32 buffers of 64 MiB made on the host) as one wall.
This script makes the same entry's inputs from a seed and, in each of
``--turns`` turns, times on them:

* ``wall_s``: ``run_entry`` whole, as phase 3 times it;
* ``copy_s``: ``carry.from_reference``, the three pageable host buffers
  copied to the card;
* ``call_s``: the ``CudaKernel`` call on those tensors: the functional
  copy of ``c`` and the launch;
* ``clone_ms`` and ``kernel_ms``: CUDA-event times of that copy of ``c``
  and of the launch alone.

Host times are ``perf_counter`` around a call closed by
``torch.cuda.synchronize()``.  The event times are of one call each, the
Python launch path included, so they lie above ``chip_smoke.py``'s
medians; turn 0's wall holds the kernels' build where the checkout has
none yet.  The last line gives each part's median over the turns.
``PYTHONPATH`` picks the checkout whose package is timed, so two
checkouts can be run in turns on one machine.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import carry
from repro_torch.core import cuda_suite, lower_cuda
from repro_torch.core.dim3 import Dim3


def host_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn):
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=7)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("vecadd_wall: no CUDA device")
        return 1
    dev = torch.device("cuda")
    entry = cuda_suite.entry_vecadd(n=1 << 24, block=128)
    args = entry.make_args(np.random.default_rng(a.seed))
    kern = lower_cuda.KERNELS["vecadd"]
    params = lower_cuda.launch_params(entry.kernel, entry.dyn_shared)
    grid, block = Dim3.of(entry.grid), Dim3.of(entry.block)
    want = args["a"] + args["b"]
    parts = {k: [] for k in ("wall_s", "copy_s", "call_s", "clone_ms",
                             "kernel_ms")}
    for turn in range(a.turns):
        out, wall = host_s(lambda: cuda_suite.run_entry(
            entry, "cuda", args=args, with_reference=False, device=dev)[0])
        if not np.array_equal(out["c"].cpu().numpy(), want):
            raise AssertionError("vecadd: c differs from a + b")
        del out
        bufs, copy = host_s(lambda: carry.from_reference(
            args, const=entry.const, device=dev))
        got, call = host_s(lambda: kern(bufs, grid=grid, block=block,
                                        **params))
        del got
        work = dict(bufs)
        clone = event_ms(lambda: work.update(c=bufs["c"].clone()))
        kernel = event_ms(lambda: kern.launch_into(work, grid, block,
                                                   **params))
        del bufs, work
        row = dict(zip(parts, (wall, copy, call, clone, kernel)))
        for k, v in row.items():
            parts[k].append(v)
        print(f"turn {turn} {a.label} " +
              " ".join(f"{k}={v}" for k, v in row.items()))
    print(f"vecadd_wall {a.label} {torch.cuda.get_device_name(0)} median " +
          " ".join(f"{k}={statistics.median(v)}" for k, v in parts.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
