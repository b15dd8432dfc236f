"""Training driver, as ``repro/launch/train.py``: config -> data -> step ->
checkpointed loop, on ``--device`` (the card unless the caller asks for
the CPU).

* auto-resume from the latest valid checkpoint (crash / preemption
  recovery): parameters, optimizer state and the data stream's step;
* async checkpoint every ``--ckpt-every`` steps, emergency save on
  SIGTERM / SIGINT (the previous handlers come back when ``main``
  returns);
* straggler monitor (per-step wall time) with grain-rebalancing advice;
* WSD or cosine schedule per arch config.

On the card the model's RMSNorm and attention forwards are the
hand-written kernels.  ``--mesh`` takes only a single device (empty or
``1x1``): the port has no mesh yet (ROADMAP 1.14.5).  CPU-scale example::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 10 --batch 4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core.memory import resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed.ft import StragglerMonitor
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import step as train_mod


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="cupbop-demo-120m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="",
                    help="single device only: empty or 1x1 (ROADMAP 1.14.5)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh not in ("", "1x1"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes "
            f"come with ROADMAP 1.14.5")
    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    opt_cfg = adamw.AdamWConfig(
        lr_peak=args.lr, schedule=cfg.schedule, total_steps=args.steps,
        warmup_steps=max(2, args.steps // 20),
        state_dtype=cfg.opt_state_dtype)
    device = resolve_device(args.device)

    params = T.init_params(cfg, 0, device=device)
    opt_state = adamw.init_state(opt_cfg, params)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        latest = mgr.latest_valid()
        if latest is not None:
            (params, opt_state), extra = mgr.restore((params, opt_state),
                                                     latest)
            start_step = extra.get("data_step", latest)
            print(f"[resume] restored step {latest} "
                  f"(data stream at {start_step})")

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                       num_codebooks=cfg.num_codebooks)
    prefetch = Prefetcher(data, start_step=start_step)

    step_fn = train_mod.make_train_step(cfg, opt_cfg,
                                        microbatches=args.microbatches)

    stop = {"now": False}

    def _sig(_s, _f):
        stop["now"] = True
    before = {s: signal.signal(s, _sig)
              for s in (signal.SIGTERM, signal.SIGINT)}

    monitor = StragglerMonitor()
    metrics = None
    try:
        for i in range(start_step, args.steps):
            dstep, batch = prefetch.next()
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            _sync(device)
            rep = monitor.record(time.time() - t0)
            if rep.is_straggler:
                print(f"[straggler] step {i}: {rep.step_time:.2f}s vs median "
                      f"{rep.median:.2f}s -> grain scale "
                      f"{rep.recommended_grain_scale:.2f}")
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {float(metrics['loss']):7.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"({rep.step_time:.2f}s)")
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, (params, opt_state),
                         extra={"data_step": dstep + 1})
            if stop["now"]:
                print("[preempt] emergency checkpoint")
                if mgr:
                    mgr.save(i + 1, (params, opt_state),
                             extra={"data_step": dstep + 1}, blocking=True)
                break
    finally:
        for s, h in before.items():
            signal.signal(s, h)
        if mgr:
            mgr.wait()
        prefetch.close()
    return float(metrics["loss"]) if metrics is not None else float("nan")


if __name__ == "__main__":
    main()
