"""Serving driver: kernel-service traffic (default) or the LM engine (--lm).

Both run on ``--device``, the card unless the caller asks for the CPU.
The default mode stands up a :class:`repro_torch.serve.KernelService`,
registers the single-launch suite kernels of ``build_suite(1)`` as
endpoints, replays two waves of a round-robin request mix through the
batching worker, and prints the :class:`~repro_torch.serve.ServiceStats`
surface::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --backend vector

``--lm`` drives the token-level tier instead (continuous-batching decode
over the decoder, :mod:`repro_torch.serve.engine`; on the card its
RMSNorm and attention are the hand-written kernels)::

  PYTHONPATH=src python -m repro_torch.launch.serve --lm --arch qwen2-0.5b \\
      --requests 8 --max-new 12

As the reference's, ``--smoke`` is on by default and cannot be turned
off, so ``--lm`` serves ``registry.smoke(--arch)``.
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


def serve_lm(args) -> dict:
    """Batched LM requests through the continuous-batching engine."""
    from repro_torch.configs import registry
    from repro_torch.core import memory
    from repro_torch.core.streams import Policy
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine

    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    device = memory.resolve_device(args.device)
    params = T.init_params(cfg, 0, device=device)
    policy = Policy.SYNC_ALWAYS if args.sync_always else Policy.HAZARD_ONLY
    eng = Engine(cfg, params, slots=args.slots,
                 max_len=args.prompt_len + args.max_new + 8, policy=policy,
                 device=device)

    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                       max_new=args.max_new)
            for _ in range(args.requests)]
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s) on {device} arch={cfg.name} "
          f"policy={policy.value} launches={eng.stats['launches']} "
          f"syncs={eng.stats['syncs']}")
    for r in reqs[:3]:
        print(f"  req{r.rid}: {r.out}")
    return eng.stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lm", action="store_true",
                    help="drive the token-level LM engine instead of the "
                         "kernel service")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=None,
                    help="request count (default: 48 a wave kernel / 8 lm)")
    # kernel-service mode
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="restrict to these suite kernels")
    ap.add_argument("--json", default=None,
                    help="write the ServiceStats snapshot here")
    # lm mode
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--sync-always", action="store_true",
                    help="HIP-CPU baseline policy (paper SVII-A.2)")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 8 if args.lm else 48
    return serve_lm(args) if args.lm else serve_kernels(args)


if __name__ == "__main__":
    main()
