"""Where the host time of a graph capture goes, for needle_nw on the card.

    PYTHONPATH=src python tools/graph_capture_profile.py

needle_nw at Rodinia's size (n = 2048) on one card: after the chain's
first launch, ``LaunchChain.capture_unit`` of 256, 1024 and 4094
iterations (each an update node and a kernel node), then the same walk
with only the kernel launches and with only the updates captured, each
timed on the host clock with the card synchronised at both ends, and a
replay of each graph timed the same way.  Last, cProfile's 25 costliest
functions (own time) over one capture of 1024 iterations.  Prints one line
a measurement.
"""
from __future__ import annotations

import cProfile
import io
import pstats
import time

import numpy as np
import torch

from repro_torch import carry
from repro_torch.core import cuda_suite
from repro_torch.core.streams import Stream


def fresh(entry, args, dev):
    """A stream over the entry's inputs after the chain's first launch."""
    stream = Stream(carry.from_reference(args, device=dev))
    step = entry.chain.steps[0]
    stream.launch(step.kernel, grid=step.grid, block=step.block,
                  backend="cuda")
    return stream, step


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def capture(stream, step, iters, *, update=True, kernel=True):
    graph = stream.begin_capture()
    for _ in range(iters):
        if update:
            stream.device_update(step.update)
        if kernel:
            stream.launch(step.kernel, grid=step.grid, block=step.block,
                          backend="cuda")
    stream.end_capture()
    return graph.instantiate(stream.buffers)


def main() -> None:
    dev = torch.device("cuda")
    print("card:", torch.cuda.get_device_name(0))
    entry = cuda_suite.entry_needle_nw(n=2048, penalty=10)
    args = entry.make_args(np.random.default_rng(42))
    for iters in (256, 1024, 4094):
        stream, step = fresh(entry, args, dev)
        ex, cap_s = timed(lambda: entry.chain.capture_unit(
            stream, iters, backend="cuda"))
        _, rep_s = timed(lambda: ex.launch(stream))
        print(f"capture_unit iters={iters} capture_s={cap_s} "
              f"capture_us_per_iter={cap_s / iters * 1e6} replay_s={rep_s}")
    for what, kw in (("kernels_only", {"update": False}),
                     ("updates_only", {"kernel": False})):
        stream, step = fresh(entry, args, dev)
        ex, cap_s = timed(lambda: capture(stream, step, 1024, **kw))
        _, rep_s = timed(lambda: ex.launch(stream))
        print(f"{what} iters=1024 capture_s={cap_s} "
              f"capture_us_per_iter={cap_s / 1024 * 1e6} replay_s={rep_s}")
    stream, step = fresh(entry, args, dev)
    prof = cProfile.Profile()
    prof.enable()
    entry.chain.capture_unit(stream, 1024, backend="cuda")
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
    print(out.getvalue())


if __name__ == "__main__":
    main()
