#!/usr/bin/env python3
"""Time two forms of a ``cuda`` batch entry on one CUDA card.

    PYTHONPATH=src python tools/serve_batch_forms.py [--rows 8] [--turns 3]

``api.launch_batch`` runs the rows of a ``cuda`` batch as plain launches
of the hand-written kernel on the current stream, one after another (the
form kept).  The other form, kept here for measurement, is the Hopper
counterpart of the reference's ``jit(vmap(...))``: one stacked buffer
``[rows, ...]`` a leaf, the rows' launches in place over its row views
captured once into a ``torch.cuda.CUDAGraph``, and every call one copy of
the rows in (``torch.stack``), one ``replay()`` and a clone of each
written row out.  It saves the host's time a launch and pays the copies:
on the card it halves a small launch's wall and doubles a 2^24-element
one's.

For each single-launch entry at ``chip_smoke.SIZES`` this script makes
``--rows`` input sets from a seed, checks both forms bit for bit against
the independent launches, then times a call of each (host clock, card
synchronised at both ends) in alternating turns, the graph warm.  It
prints one ``form <entry>:`` line an entry with both walls a request and
their ratio, and a ``forms sum`` line with their sums.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (SIZES and the entries at them)

from repro_torch import carry  # noqa: E402
from repro_torch.core import api, cuda_suite, lower_cuda, packing  # noqa
from repro_torch.core.dim3 import Dim3  # noqa: E402


class GraphBatch:
    """``n`` in-place launches of one hand-written kernel over stacked
    buffers, captured once into a CUDA graph and replayed each call."""

    def __init__(self, entry, n: int):
        self.entry, self.n = entry, n
        self.kern = lower_cuda.kernel_for(entry.kernel)
        self.params = lower_cuda.launch_params(entry.kernel,
                                               entry.dyn_shared)
        self.grid, self.block = Dim3.of(entry.grid), Dim3.of(entry.block)
        self.names: tuple = ()
        self.stacked: list[torch.Tensor] = []
        self.graph = None

    def _launch_rows(self) -> None:
        with lower_cuda.in_place():
            for i in range(self.n):
                glob = packing.unpack([s[i] for s in self.stacked],
                                      self.names)
                self.kern(glob, grid=self.grid, block=self.block,
                          **self.params)

    def __call__(self, rows: list[dict]) -> list[dict]:
        leaves = [packing.pack(
            {k: getattr(v, "value", v) for k, v in r.items()})
            for r in rows]
        if not self.stacked:
            self.names = leaves[0][1]
            self.stacked = [torch.empty((self.n, *t.shape), dtype=t.dtype,
                                        device=t.device)
                            for t in leaves[0][0]]
        for j, s in enumerate(self.stacked):
            torch.stack([lv[0][j] for lv in leaves], out=s)
        if self.graph is None:
            self._launch_rows()          # loads the kernel outside capture
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            before = self.kern.launches
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self._launch_rows()
            self.kern.launches = before  # the capture launched nothing
        else:
            self.graph.replay()
            self.kern.launches += self.n
        written = set(self.entry.kernel.writes)
        return [{name: self.stacked[j][i].clone() for j, name
                 in enumerate(self.names) if name in written}
                for i in range(self.n)]


def host_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_batch_forms: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {chip_smoke.card_line()}")
    ents = chip_smoke.entries(cuda_suite)
    rng = np.random.default_rng(chip_smoke.SEED)
    sums = {"plain": 0.0, "graph": 0.0}
    for name, e in ents.items():
        if e.chain is not None or name in chip_smoke.VARIANTS:
            continue
        rows = [carry.from_reference(e.make_args(rng), const=e.const,
                                     device=dev) for _ in range(args.rows)]
        kw = dict(grid=e.grid, block=e.block, dyn_shared=e.dyn_shared,
                  backend="cuda")
        solo = [api.launch(e.kernel, args=a, **kw) for a in rows]
        graph = GraphBatch(e, args.rows)
        forms = {"plain": functools.partial(api.launch_batch, e.kernel,
                                            args_list=rows, **kw),
                 "graph": functools.partial(graph, rows)}
        best = dict.fromkeys(forms, float("inf"))
        for turn in range(args.turns + 1):
            order = ("plain", "graph") if turn % 2 else ("graph", "plain")
            for form in order:
                out, wall = host_s(forms[form])
                for got, want in zip(out, solo):
                    for k in e.kernel.writes:
                        if not torch.equal(got[k], want[k]):
                            raise AssertionError(f"{name} {form}: {k} "
                                                 f"differs")
                if turn:                 # turn 0 builds and captures
                    best[form] = min(best[form], wall)
        per = {f: best[f] / args.rows * 1e3 for f in forms}
        for f in forms:
            sums[f] += per[f]
        print(f"form {name}: rows={args.rows} "
              f"plain_ms_per_request={per['plain']} "
              f"graph_ms_per_request={per['graph']} "
              f"ratio={per['graph'] / per['plain']} bits=equal")
        del rows, solo, graph, forms
        api.cache_clear()
    print(f"forms sum: plain_ms={sums['plain']} graph_ms={sums['graph']} "
          f"ratio={sums['graph'] / sums['plain']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
