#!/usr/bin/env python3
"""needle_nw's and pathfinder's chains in each mode on one CUDA card.

    PYTHONPATH=src python tools/chain_modes.py [--turns 3] [--label NAME]

Runs the two chains at ``chip_smoke.py``'s ``SIZES`` (4,095 and 99
launches) through ``cuda_suite.run_entry(..., backend="cuda")`` in host,
device and graph mode, as phase 3b does, and prints a line a turn and
entry with, in microseconds a launch:

* ``host_us``, ``device_us`` and ``graph_us``: each mode's wall (the card
  synchronised at both ends) over the chain's launches;
* ``replay_us``: graph mode run again with each unit capture and each
  replay synchronised at both ends, the replays' time over the launches
  they replayed (phase 3b's ``replay_us``); ``capture_s`` beside it.

Every mode's buffers must equal host mode's bit for bit.  The last lines
give each figure's median over the turns; turn 0 holds the kernels' build
where the checkout has none yet.  ``PYTHONPATH`` picks the checkout whose
package is timed (its kernels are built in that checkout), so a change
and its parent (``git archive`` under ``build/``) can be run in turns on
one machine: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import cuda_suite
from repro_torch.core.graphs import GraphExec
from repro_torch.core.kernel import ChainStats, LaunchChain

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("needle_nw", "pathfinder")


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(entry, args, mode):
    """One run: its buffers on the host, its wall (s) and its stats."""
    stats = ChainStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = cuda_suite.run_entry(entry, "cuda", args=args,
                                  with_reference=False, chain_mode=mode,
                                  chain_stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ({k: v.cpu() for k, v in out.items()
             if k not in entry.iteration_state}, wall, stats)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--label", default="change")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chain_modes: no CUDA device")
    cs = chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; package: {cuda_suite.__file__}")
    keys = ("host_us", "device_us", "graph_us", "replay_us", "capture_s")
    seen = {n: {k: [] for k in keys} for n in NAMES}
    for turn in range(opts.turns):
        for name in NAMES:
            entry = getattr(cuda_suite, f"entry_{name}")(**cs.SIZES[name])
            args = entry.make_args(np.random.default_rng(cs.SEED))
            host, wall, st = run(entry, args, "host")
            fig = {"host_us": wall / st.launches * 1e6}
            for mode in ("device", "graph"):
                got, wall, st = run(entry, args, mode)
                fig[f"{mode}_us"] = wall / st.launches * 1e6
                for k, v in host.items():
                    if not torch.equal(got[k], v):
                        raise AssertionError(f"{name}/{mode}: {k} differs "
                                             f"from host mode")
            spans = {"capture": 0.0, "replay": 0.0}
            with cs.graph_spans(spans, LaunchChain, GraphExec):
                _, _, st = run(entry, args, "graph")
            replayed = st.graph_replays * cs.graph_unit(entry.chain) \
                * len(entry.chain.steps)
            fig["replay_us"] = spans["replay"] / replayed * 1e6
            fig["capture_s"] = spans["capture"]
            for k in keys:
                seen[name][k].append(fig[k])
            print(f"chain_modes {opts.label} turn {turn} {name}: "
                  + " ".join(f"{k}={fig[k]}" for k in keys))
    for name in NAMES:
        print(f"chain_modes {opts.label} median {name}: " + " ".join(
            f"{k}={statistics.median(v)}" for k, v in seen[name].items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
