"""Decoder LM, the dense families, as ``repro/models/transformer.py``.

Parameters keep the reference's nested dict and its stacked layer axis
(``params["layers"]`` leaves are ``[L, ...]``); the layers run in a Python
loop over views of it (one ``unbind`` a leaf, so a backward stacks each
leaf's gradient once).  Training goes through :func:`loss_fn`: the same
forward under ``cfg.remat`` (:func:`_remat`: ``torch.utils.checkpoint``
around each layer), the gradient cast of :func:`_grad_cast` before the
head, and :func:`~repro_torch.models.common.cross_entropy`.  The
reference's ``constrain`` is the identity without a mesh, and the port has
none, so it is left out (:func:`res_constrain` keeps its name).

A config with experts (``moe``), a state-space or RWKV mixer (``ssm``,
``rwkv``), several codebooks or a patch prefix raises
``NotImplementedError``: those families come in later slices of ROADMAP
1.14.

``mode`` (``repro_torch.kernels.ops.MODES``) reaches every RMSNorm and
attention call: ``None`` launches the hand-written kernels for tensors on
the card and runs their plain versions for tensors on the CPU;
``"interpret"`` runs the plain versions on any device.

Entry points:
  init_params(cfg, seed, *, device)               -> params
  forward(cfg, params, batch, *, mode)            -> (logits, aux)
  loss_fn(cfg, params, batch, *, mode)            -> (loss, metrics)
  init_cache(cfg, batch, max_len, *, device)      -> decode cache
  prefill(cfg, params, batch, max_len, *, mode)   -> (logits_last, cache)
  decode_step(cfg, params, cache, tokens, *, mode) -> (logits, cache)
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import index
from repro_torch.core.memory import resolve_device
from repro_torch.models import attention
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (cross_entropy, dense, rmsnorm,
                                       uniform_init)


def check_dense(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder, the family ported so far."""
    other = [name for name, on in (
        ("moe", cfg.moe is not None), ("ssm", cfg.ssm is not None),
        ("rwkv", cfg.rwkv is not None),
        ("num_codebooks", cfg.num_codebooks > 1),
        ("patch_prefix", bool(cfg.patch_prefix))) if on]
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(other)} not ported yet; the port's LM "
            f"stack serves dense decoders (ROADMAP 1.14)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, gen: torch.Generator):
    D = cfg.d_model
    return {"ln1": torch.zeros(D, dtype=torch.float32, device=gen.device),
            "ln2": torch.zeros(D, dtype=torch.float32, device=gen.device),
            "attn": attention.init_attn_params(gen, cfg),
            "mlp": mlp_mod.init_mlp_params(gen, D, cfg.d_ff, cfg.pdtype)}


def _stack(trees):
    """Layer dicts -> one dict of ``[L, ...]`` leaves (the reference's
    ``vmap`` over layer keys)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random parameters on ``device`` (the card unless ``"cpu"`` is asked
    for), drawn from a ``torch.Generator`` seeded with ``seed`` on that
    device, with the reference's shapes, dtypes and bounds (its values
    come from JAX's generator: carry them with
    ``repro_torch.carry.params_from_reference``)."""
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, Vp = cfg.d_model, cfg.padded_vocab
    params: dict[str, Any] = {
        "embed": {"tok": uniform_init(gen, (Vp, D), 1.0, cfg.pdtype)}}
    params["layers"] = _stack([_init_layer(cfg, gen)
                               for _ in range(cfg.num_layers)])
    params["final_norm"] = torch.zeros(D, dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = uniform_init(gen, (D, Vp), 1.0, cfg.pdtype)
    return params


def layer_params(params, i: int):
    """Layer ``i``'s parameters: views of the stacked ``[L, ...]`` leaves."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"])


def _layers(params, L: int) -> list:
    """Every layer's parameters, views of the stacked leaves by one
    ``unbind`` a leaf: under autograd each leaf's gradient is then stacked
    once, where ``L`` selects would each fill an ``[L, ...]`` zeros."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(L)]
        return tree.unbind(0)
    return split(params["layers"])


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def embed(cfg: ModelConfig, params, batch):
    """The token rows, gathered by JAX's rule (``index.take``: a negative
    id wraps once, then an id still out of range clamps), as the
    reference's ``e["tok"][tokens]`` gathers them.  Its gradient, as
    ``jax.grad`` of that gather, drops the rows of ids out of range after
    the wrap: JAX's transpose is a scatter that skips them."""
    tok = params["embed"]["tok"]
    ids = torch.as_tensor(batch["tokens"], device=tok.device).long()
    x = index.take(tok, ids)
    if torch.is_grad_enabled() and tok.requires_grad:
        V = tok.shape[0]
        wrapped = torch.where(ids < 0, ids + V, ids)
        inside = ((wrapped >= 0) & (wrapped < V))[..., None]
        x = torch.where(inside, x, x.detach())
    return x.to(cfg.cdtype)                               # [B, S, D]


class _GradCast(torch.autograd.Function):
    """Identity forward; the cotangent rounded to ``dtype`` and back in the
    backward (the reference's ``_grad_cast``)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _grad_cast(dtype_name: str):
    """The reference's ``_grad_cast(dtype_name)``: a function of ``x``."""
    dtype = getattr(torch, dtype_name)
    return lambda x: _GradCast.apply(x, dtype)


def head(cfg: ModelConfig, params, x, *, mode=None):
    if cfg.compute_dtype != "float32" and torch.is_grad_enabled() \
            and x.requires_grad:
        x = _grad_cast(cfg.compute_dtype)(x)
    xn = rmsnorm(x, params["final_norm"], cfg.norm_eps, mode=mode)
    w = (params["embed"]["tok"].t() if cfg.tie_embeddings
         else params["lm_head"])
    return dense(xn, w, compute_dtype=cfg.cdtype).float()


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------
def _mlp_half(cfg: ModelConfig, lp, x, mode):
    xn = rmsnorm(x, lp["ln2"], cfg.norm_eps, mode=mode)
    return x + mlp_mod.mlp_block(cfg, lp["mlp"], xn)


def _layer_full(cfg: ModelConfig, plan, lp, x, positions, mode):
    """One layer, full sequence. Returns (x, (k, v))."""
    a, kv = attention.attend_full(
        cfg, plan, lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps, mode=mode),
        positions, mode=mode)
    return _mlp_half(cfg, lp, x + a, mode), kv


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device).expand(B, S)


def res_constrain(cfg: ModelConfig, x):
    """Residual-stream sharding between layers: the identity, as the
    reference's ``constrain`` is without a mesh (the port has none)."""
    return x


#: the ops whose outputs remat ``dots`` keeps (``checkpoint_dots``: the
#: results of matrix products); every other op is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` when a gradient is asked for: ``none``
    keeps every activation; ``full`` keeps only ``fn``'s inputs and
    recomputes the rest in the backward
    (``torch.utils.checkpoint.checkpoint``, non-reentrant, as
    ``jax.checkpoint``); ``dots`` keeps the matrix products' outputs and
    recomputes the rest (a selective checkpoint, as
    ``checkpoint_policies.checkpoint_dots``)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r} is not none, full or dots")
    if cfg.remat == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat == "full":
            return ckpt.checkpoint(fn, *args, use_reentrant=False)
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    return run


def forward(cfg: ModelConfig, params, batch, *, mode=None):
    """Full-sequence forward. Returns (logits, aux); aux is 0 for the
    dense families (the reference's expert load-balance term).  Under
    autograd each layer runs under ``cfg.remat``."""
    check_dense(cfg)
    plan = attention.plan_for(cfg)
    x = embed(cfg, params, batch)
    positions = _positions(x)

    def body(lp, x):
        x, _ = _layer_full(cfg, plan, lp, x, positions, mode)
        return res_constrain(cfg, x)

    body = _remat(cfg, body)
    x = res_constrain(cfg, x)
    for lp in _layers(params, cfg.num_layers):
        x = body(lp, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return head(cfg, params, x, mode=mode), aux


def loss_fn(cfg: ModelConfig, params, batch, aux_weight=0.01, *, mode=None):
    """Next-token cross-entropy of :func:`forward`'s logits (after the
    patch prefix, which dense configs do not have) against the batch's
    tokens, over the real vocabulary, plus ``aux_weight`` times the aux
    term.  Returns ``(loss, {"ce", "aux"})``."""
    logits, aux = forward(cfg, params, batch, mode=mode)
    toks = torch.as_tensor(batch["tokens"], device=logits.device)
    lg = logits[:, cfg.patch_prefix:, :]
    ce = cross_entropy(lg[:, :-1], toks[:, 1:], real_vocab=cfg.vocab_size)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device=None):
    """``{"pos": 0, "k", "v": [L, B, max_len, Hkv_p, hd]}`` zeros in the
    compute dtype; ``pos`` is a host int."""
    check_dense(cfg)
    dev = resolve_device(device)
    plan = attention.plan_for(cfg)
    shape = (cfg.num_layers, batch_size, max_len, plan.hkv_p, cfg.hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev)}


def decode_step(cfg: ModelConfig, params, cache, tokens, *, mode=None):
    """One decode step. tokens: [B, 1]. Returns (logits, cache).

    The cache's ``k`` / ``v`` are written in place at ``pos`` (the
    reference donates them to its jitted step); the returned dict holds
    the same tensors and ``pos + 1``.  Keys past ``pos`` are never read,
    so a step may be taken again from the dict it was given."""
    check_dense(cfg)
    plan = attention.plan_for(cfg)
    x = embed(cfg, params, {"tokens": tokens})
    pos = cache["pos"]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        a, _, _ = attention.attend_decode(
            cfg, plan, lp["attn"],
            rmsnorm(x, lp["ln1"], cfg.norm_eps, mode=mode),
            cache["k"][i], cache["v"][i], pos, mode=mode)
        x = _mlp_half(cfg, lp, x + a, mode)
    new_cache = {"pos": pos + 1, "k": cache["k"], "v": cache["v"]}
    return head(cfg, params, x, mode=mode), new_cache


def prefill(cfg: ModelConfig, params, batch, max_len: int, *, mode=None):
    """Run the prompt, build a decode cache. Returns (logits_last, cache)."""
    check_dense(cfg)
    plan = attention.plan_for(cfg)
    x = embed(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(x)
    cache = init_cache(cfg, B, max_len, device=x.device)
    for i in range(cfg.num_layers):
        x, (k, v) = _layer_full(cfg, plan, layer_params(params, i), x,
                                positions, mode)
        cache["k"][i, :, :S] = k.to(cfg.cdtype)
        cache["v"][i, :, :S] = v.to(cfg.cdtype)
    cache["pos"] = S
    return head(cfg, params, x[:, -1:, :], mode=mode), cache
