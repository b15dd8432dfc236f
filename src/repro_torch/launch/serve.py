"""Serving driver: kernel-service traffic over the suite's single launches.

Stands up a :class:`repro_torch.serve.KernelService` on ``--device`` (the
card unless the caller asks for the CPU), registers the single-launch
suite kernels of ``build_suite(1)`` as endpoints, replays two waves of a
round-robin request mix through the batching worker, and prints the
:class:`~repro_torch.serve.ServiceStats` surface::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --backend vector

``--lm`` names the reference's token-level tier, which comes with the LM
stack (ROADMAP 1.14).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def serve_kernels(args) -> dict:
    """Smoke a kernel-service under round-robin suite traffic."""
    from repro_torch import carry
    from repro_torch.core import memory
    from repro_torch.core.cuda_suite import build_suite
    from repro_torch.serve import KernelService

    entries = [e for e in build_suite(scale=1) if e.chain is None]
    if args.kernels:
        keep = set(args.kernels)
        entries = [e for e in entries if e.name in keep]
        if not entries:
            raise SystemExit(f"no suite kernels match {sorted(keep)}")
    device = memory.resolve_device(args.device)
    rng = np.random.default_rng(0)
    with KernelService(backend=args.backend, max_batch=args.max_batch,
                       admission_window_ms=args.window_ms,
                       default_timeout_s=args.timeout,
                       device=device) as svc:
        for e in entries:
            svc.register_entry(e)
        t0 = time.perf_counter()
        # two waves: the first builds each specialization, the second is
        # the warm traffic the service exists for - so the stats show
        # cache hits, not just one cold dispatch per endpoint
        for _wave in range(2):
            tickets = []
            for i in range(args.requests):
                e = entries[i % len(entries)]
                bufs = carry.from_reference(e.make_args(rng), device=device)
                tickets.append(svc.submit(e.name, bufs))
            for t in tickets:
                t.result(timeout=args.timeout)
        dt = time.perf_counter() - t0
        stats = svc.stats()
    doc = stats.to_json()
    n = 2 * args.requests
    print(f"served {n} requests over {len(entries)} endpoints "
          f"in {dt:.2f}s ({n / dt:.1f} req/s) on {device} "
          f"backend={args.backend} warm_hit_rate={stats.warm_hit_rate} "
          f"dispatches={stats.dispatches} "
          f"occupancy={doc['batch_occupancy']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"stats written to {args.json}")
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lm", action="store_true",
                    help="the token-level LM tier (not ported yet)")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card)")
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--requests", type=int, default=48,
                    help="requests a wave")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="restrict to these suite kernels")
    ap.add_argument("--json", default=None,
                    help="write the ServiceStats snapshot here")
    args = ap.parse_args(argv)
    if args.lm:
        raise NotImplementedError(
            "the LM serving tier is not ported yet: ROADMAP 1.14 (LM stack)")
    return serve_kernels(args)


if __name__ == "__main__":
    main()
