"""Train and eval steps with microbatch accumulation, as
``repro/train/step.py``.

A step is eager: the loss's backward through ``torch.autograd.grad`` over
every parameter leaf (the reference's ``jax.value_and_grad``), then
``optim.adamw.apply_updates``.  The batch's NumPy tokens move to the
parameters' device once a step.  ``mode`` (``kernels.ops.MODES``)
reaches the model's RMSNorm and attention: ``None`` launches the
hand-written kernels for tensors on the card.

Under a mesh (``distributed.sharding.use_mesh``) with DTensor parameters
the batch is split by ``sharding.batch_placements`` and each gradient is
brought to its parameter's placements (the FSDP reduce-scatter) before
the update.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def make_loss(cfg: ModelConfig, *, mode=None):
    def loss(params, batch):
        return T.loss_fn(cfg, params, batch, mode=mode)
    return loss


def _on(batch, device) -> dict:
    """The batch's leaves on ``device``; under a mesh of several devices,
    DTensors split by ``sharding.batch_placements``."""
    mesh = shd.active_mesh()
    out = {}
    for k, v in batch.items():
        if not isinstance(v, shd.DTensor):
            v = torch.as_tensor(v, device=device)
            if mesh is not None and shd.mesh_size(mesh) > 1:
                v = shd.distribute(v, mesh, shd.batch_placements(mesh,
                                                                 v.shape))
        out[k] = v
    return out


def value_and_grad(loss, params, batch):
    """``((loss, metrics), grads)`` of ``loss(params, batch)`` (the
    reference's ``jax.value_and_grad(loss, has_aux=True)``): grads in each
    leaf's dtype, the loss and metrics detached."""
    leaves = adamw.tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tracked = adamw.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        l, metrics = loss(tracked, batch)
        grads = torch.autograd.grad(l, live)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(p, shd.DTensor) else g
             for p, g in zip(live, grads, strict=True)]
    it = iter(grads)
    return ((l.detach(), {k: v.detach() for k, v in metrics.items()}),
            adamw.tree_map(lambda _: next(it), params))


def train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, params,
               opt_state, batch, microbatches: int = 1, *, mode=None):
    """One optimizer step; with ``microbatches`` > 1 the batch is split on
    its first axis and the gradients summed in float32 over the parts,
    then divided by their count (the loss too).  Returns ``(params,
    opt_state, metrics)``."""
    loss = make_loss(cfg, mode=mode)
    batch = _on(batch, adamw.tree_leaves(params)[0].device)
    if microbatches == 1:
        (l, metrics), grads = value_and_grad(loss, params, batch)
    else:
        def split(x, i):
            n = x.shape[0] // microbatches
            return x[i * n:(i + 1) * n]

        gsum = adamw.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        lsum = 0.0
        for i in range(microbatches):
            mb = {k: split(v, i) for k, v in batch.items()}
            (l, _), g = value_and_grad(loss, params, mb)
            gsum = adamw.tree_map(torch.add, gsum, g)
            lsum = lsum + l
        grads = adamw.tree_map(lambda g: g / microbatches, gsum)
        l = lsum / microbatches
        metrics = {}
    params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                opt_state)
    return params, opt_state, {"loss": l, **metrics, **om}


def eval_step(cfg: ModelConfig, params, batch, *, mode=None):
    with torch.no_grad():
        l, metrics = make_loss(cfg, mode=mode)(
            params, _on(batch, adamw.tree_leaves(params)[0].device))
    return {"loss": l, **metrics}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, *, mode=None):
    return functools.partial(train_step, cfg, opt_cfg,
                             microbatches=microbatches, mode=mode)
