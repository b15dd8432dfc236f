"""AdamW with a configurable state dtype, WSD / cosine / linear / constant
schedules and a global clip, as ``repro/optim/adamw.py``.

Parameters, gradients and moments are the model's nested dicts of
tensors.  The arithmetic is the reference's, in float32, leaf by leaf:
every schedule value, bias correction and update is a float32 tensor
(the reference's jnp scalars are float32), and the moments are stored in
``state_dtype``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32, 0-d
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    # schedule
    schedule: str = "cosine"          # cosine | wsd | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1           # WSD: fraction of steps in final decay
    lr_min_ratio: float = 0.1


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 0-d tensor on the step's device (the CPU for an int)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    s = _f32(step, dev)
    one = _f32(1.0, dev)
    warm = torch.minimum(one, s / _f32(max(cfg.warmup_steps, 1), dev))
    t = torch.clamp((s - cfg.warmup_steps)
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
                    0, 1)
    if cfg.schedule == "cosine":
        mult = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # warmup -> stable -> linear decay tail (MiniCPM, arXiv:2404.06395)
        decay_start = 1.0 - cfg.decay_frac
        frac = torch.clamp((t - decay_start) / cfg.decay_frac, 0, 1)
        mult = 1.0 - (1.0 - cfg.lr_min_ratio) * frac
    elif cfg.schedule == "linear":
        mult = 1.0 - (1.0 - cfg.lr_min_ratio) * t
    else:
        mult = one
    return cfg.lr_peak * warm * mult


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts with the same keys, in
    :func:`tree_leaves`' order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, keys sorted at every level (the order
    ``jax.tree.leaves`` gives)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_state(cfg: AdamWConfig, params) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    first = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                         device=p.device), params))


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """Returns (new_params, new_state, metrics): the gradients clipped to
    a global norm of ``clip_norm``, bias-corrected moments, decay on the
    matrices only (``ndim >= 2``; norms and biases exempt)."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.minimum(_f32(1.0, dev),
                          cfg.clip_norm / torch.clamp(gnorm, min=1e-9))
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - torch.pow(_f32(cfg.b1, dev), step.float())
    b2c = 1 - torch.pow(_f32(cfg.b2, dev), step.float())
    dt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        gf = g.float() * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mhat, vhat = mf / b1c, vf / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (norms/biases exempt)
            delta = delta + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), mf.to(dt), vf.to(dt)

    out = tree_map(upd, params, grads, state.m, state.v)

    def pick(i):
        return tree_map(lambda o: o[i], out)
    return pick(0), AdamWState(step, pick(1), pick(2)), {
        "grad_norm": gnorm, "lr": lr}
