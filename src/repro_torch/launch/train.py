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
hand-written kernels.  ``--mesh 2x2`` (``data``, ``model``) or ``2x2x2``
(``pod``, ``data``, ``model``) builds a DeviceMesh over the default
process group (started by the caller's ranks, or from ``WORLD_SIZE`` /
``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``; a group of one is started
here); the parameters and the AdamW moments are sharded by
``sharding.param_specs``, the batch by ``specs.batch_sharding``, and
every rank logs the same loss.  CPU-scale examples::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 10 --batch 4 --seq 32 --device cpu
  # 4 ranks of one machine (torchrun sets the group's variables)
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-0.5b --smoke --steps 10 --batch 8 --seq 32 --mesh 2x2 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import math
import os
import signal
import tempfile
import time

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core.memory import resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ft import StragglerMonitor
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import step as train_mod


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_group(dims, device: torch.device) -> bool:
    """The default process group, unless the caller started one: from the
    launcher's ``WORLD_SIZE`` / ``RANK`` variables when there are several
    ranks, else a group of one (a file store in a temporary directory).
    Raises, starting nothing, when the world is not ``prod(dims)`` ranks;
    returns whether it started the group."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    need, have = math.prod(dims), int(os.environ.get("WORLD_SIZE", "1"))
    if have != need:
        raise RuntimeError(f"mesh {tuple(dims)} needs a process group of "
                           f"{need} ranks, have {have}")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if have > 1:
        dist.init_process_group(backend)
        return True
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1)
    return True


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
                    help="e.g. 2x2 -> (data, model); empty = single device")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    opt_cfg = adamw.AdamWConfig(
        lr_peak=args.lr, schedule=cfg.schedule, total_steps=args.steps,
        warmup_steps=max(2, args.steps // 20),
        state_dtype=cfg.opt_state_dtype)
    device = resolve_device(args.device)

    mesh, started = None, False
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        names = ("data", "model")[: len(dims)] if len(dims) <= 2 else \
            ("pod", "data", "model")
        started = _start_group(dims, device)
        mesh = shd.make_mesh(dims, names, device=device)

    params = T.init_params(cfg, 0, device=device)
    opt_state = adamw.init_state(opt_cfg, params)
    if mesh is not None:
        params = shd.shard_params(params, mesh)
        opt_state = shd.shard_params(opt_state, mesh)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        latest = mgr.latest_valid()
        if latest is not None:
            (params, opt_state), extra = mgr.restore(
                (params, opt_state), latest, mesh=mesh)
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
    ctx = shd.use_mesh(mesh)
    ctx.__enter__()
    try:
        for i in range(start_step, args.steps):
            dstep, batch = prefetch.next()
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: shd.full(v) for k, v in metrics.items()}
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
        ctx.__exit__(None, None, None)
        for s, h in before.items():
            signal.signal(s, h)
        if mgr:
            mgr.wait()
        prefetch.close()
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()
    return float(metrics["loss"]) if metrics is not None else float("nan")


if __name__ == "__main__":
    main()
