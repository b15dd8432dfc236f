"""Decoder LM covering every family of the registry (dense, moe, audio,
vlm, hybrid, ssm), as ``repro/models/transformer.py``.

Parameters keep the reference's nested dict and its stacked layer axis
(``params["layers"]`` leaves are ``[L, ...]``); the layers run in a Python
loop over views of it (one ``unbind`` a leaf, so a backward stacks each
leaf's gradient once).  Training goes through :func:`loss_fn`: the same
forward under ``cfg.remat`` (:func:`_remat`: ``torch.utils.checkpoint``
around each layer), the gradient cast of :func:`_grad_cast` before the
head, and :func:`~repro_torch.models.common.cross_entropy`.

Under a mesh (``distributed.sharding.use_mesh``, the parameters
``shard_params``'d into DTensors) the stream is constrained where the
reference constrains it (the embedding, the residual stream between
layers - :func:`res_constrain`, split on the sequence under
``cfg.seq_parallel`` - and the logits); the embedding's gather runs on
the whole table and each device's rows (``sharding.local_call``).
Without a mesh, or on one device, every ``constrain`` is the identity.

An attention layer's feed-forward half is the SwiGLU MLP or, with
``cfg.moe``, the mixture of experts of :mod:`repro_torch.models.moe`,
whose load-balance term :func:`forward` averages over the layers
(``aux``).  Several codebooks (``num_codebooks``, musicgen) sum one
embedding a codebook and give ``[B, S, K, Vp]`` logits from one head a
codebook; a patch prefix (internvl2) puts the projected ``patch_embeds``
of the batch in front of the tokens.  With ``cfg.rwkv`` a layer is
RWKV6's time mix and channel mix (:mod:`repro_torch.models.rwkv6`); with
``cfg.ssm`` it is a Mamba2 mixer (:mod:`repro_torch.models.mamba2`), and
with ``cfg.attn_every`` one attention block whose parameters all blocks
share (``params["shared_attn"]``) runs before every ``attn_every``-th
layer (zamba2's hybrid layout, :func:`hybrid_blocks`).  Their decode
caches hold each layer's recurrent state instead of keys and values.

``mode`` (``repro_torch.kernels.ops.MODES``) reaches every RMSNorm and
attention call: ``None`` launches the hand-written kernels for tensors on
the card and runs their plain versions for tensors on the CPU;
``"interpret"`` runs the plain versions on any device.

Entry points:
  init_params(cfg, seed, *, device)               -> params
  abstract_params(cfg)                            -> params on meta
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
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention, mamba2, rwkv6
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (MetaDraws, cross_entropy, dense,
                                       rmsnorm, uniform_init)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, gen: torch.Generator):
    D = cfg.d_model

    def norm():
        return torch.zeros(D, dtype=torch.float32, device=gen.device)

    if cfg.rwkv is not None:
        return {"ln1": norm(), "ln2": norm(),
                "rwkv": rwkv6.init_rwkv_params(gen, cfg)}
    if cfg.ssm is not None:  # hybrid: mamba backbone (shared attn is global)
        return {"ln1": norm(), "mamba": mamba2.init_mamba_params(gen, cfg)}
    layer = {"ln1": norm(), "ln2": norm(),
             "attn": attention.init_attn_params(gen, cfg)}
    if cfg.moe is not None:
        layer["moe"] = moe_mod.init_moe_params(gen, cfg)
    else:
        layer["mlp"] = mlp_mod.init_mlp_params(gen, D, cfg.d_ff, cfg.pdtype)
    return layer


def _init_layers(cfg: ModelConfig, gen: torch.Generator):
    """Every layer's parameters as ``[L, ...]`` leaves (the reference's
    ``vmap`` over layer keys), drawn layer by layer and copied into leaves
    allocated once: the peak holds the stack and one layer, not two
    stacks."""
    def alloc(tree):
        if isinstance(tree, dict):
            return {k: alloc(v) for k, v in tree.items()}
        return tree.new_empty((cfg.num_layers,) + tuple(tree.shape))

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    layer = _init_layer(cfg, gen)
    out = alloc(layer)
    for i in range(cfg.num_layers):
        if i:
            layer = _init_layer(cfg, gen)
        fill(out, layer, i)
        del layer
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random parameters on ``device`` (the card unless ``"cpu"`` is asked
    for), drawn from a ``torch.Generator`` seeded with ``seed`` on that
    device, with the reference's shapes, dtypes and bounds (its values
    come from JAX's generator: carry them with
    ``repro_torch.carry.params_from_reference``).  The draws go embedding
    (``tok`` or ``codebooks``), ``patch_proj``, the layers in order, the
    hybrid's ``shared_attn``, then ``lm_head`` or ``lm_heads``.  On the
    meta device nothing is drawn (:func:`abstract_params`)."""
    dev = resolve_device(device)
    gen = (MetaDraws() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    D, Vp, K = cfg.d_model, cfg.padded_vocab, cfg.num_codebooks
    if K > 1:
        emb = {"codebooks": uniform_init(gen, (K, Vp, D), 1.0, cfg.pdtype)}
    else:
        emb = {"tok": uniform_init(gen, (Vp, D), 1.0, cfg.pdtype)}
    if cfg.patch_prefix:
        emb["patch_proj"] = uniform_init(gen, (D, D), 1.0, cfg.pdtype)
    params: dict[str, Any] = {"embed": emb}
    params["layers"] = _init_layers(cfg, gen)
    if cfg.ssm is not None and cfg.attn_every:
        params["shared_attn"] = {
            "ln": torch.zeros(D, dtype=torch.float32, device=dev),
            "attn": attention.init_attn_params(gen, cfg)}
    params["final_norm"] = torch.zeros(D, dtype=torch.float32, device=dev)
    if K > 1:
        params["lm_heads"] = uniform_init(gen, (K, D, Vp), 1.0, cfg.pdtype)
    elif not cfg.tie_embeddings:
        params["lm_head"] = uniform_init(gen, (D, Vp), 1.0, cfg.pdtype)
    return params


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the meta device: :func:`init_params`' shapes
    and dtypes, nothing allocated or drawn (the reference's
    ``jax.eval_shape`` of its init)."""
    return init_params(cfg, device="meta")


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
    once, where ``L`` selects would each fill an ``[L, ...]`` zeros; and
    a decode step enqueues one op a leaf, not one a leaf and layer."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(L)]
        return tree.unbind(0)
    return split(params["layers"])


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def _gather(table, ids):
    """``table[ids]`` by JAX's rule (``index.take``: a negative id wraps
    once, then an id still out of range clamps).  Its gradient, as
    ``jax.grad`` of that gather, drops the rows of ids out of range after
    the wrap: JAX's transpose is a scatter that skips them."""
    x = index.take(table, ids)
    if torch.is_grad_enabled() and table.requires_grad:
        V = table.shape[0]
        wrapped = torch.where(ids < 0, ids + V, ids)
        inside = ((wrapped >= 0) & (wrapped < V))[..., None]
        x = torch.where(inside, x, x.detach())
    return x


def embed(cfg: ModelConfig, params, batch):
    """The token rows by :func:`_gather`, as the reference's
    ``e["tok"][tokens]``; with several codebooks the sum of each
    codebook's rows for its ids (``tokens`` ``[B, S, K]``), added in
    codebook order in the parameters' dtype, then cast, as the
    reference's ``sum(parts)``.  With a patch prefix and ``patch_embeds``
    ``[B, P, D]`` in the batch, their ``patch_proj`` product goes in
    front of the tokens."""
    e = params["embed"]
    if cfg.num_codebooks > 1:
        books = e["codebooks"]
        ids = _on(batch["tokens"], books).long()
        x = _rows(books[0], ids[..., 0])
        for k in range(1, cfg.num_codebooks):
            x = x + _rows(books[k], ids[..., k])
    else:
        tok = e["tok"]
        ids = _on(batch["tokens"], tok).long()
        x = _rows(tok, ids)
    x = x.to(cfg.cdtype)                                  # [B, S, D]
    if cfg.patch_prefix and "patch_embeds" in batch:
        pe = _on(batch["patch_embeds"], x)
        pe = dense(pe.to(cfg.cdtype), e["patch_proj"],
                   compute_dtype=cfg.cdtype)
        x = torch.cat([pe, x], dim=1)
    return constrain(x, "batch", "seq", None)


def _on(t, like):
    """A batch leaf on ``like``'s device; a DTensor leaf as it is."""
    if isinstance(t, shd.DTensor):
        return t
    return torch.as_tensor(t, device=like.device)


def _rows(table, ids):
    """:func:`_gather`; a DTensor table is made whole and gathered by each
    device's ids (the batch split kept)."""
    if not isinstance(table, shd.DTensor):
        return _gather(table, ids)
    return shd.local_call(_gather, table, shd.like_batch(ids, table),
                          keep=(0,), out_like=1, whole=(0,))


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
    if cfg.num_codebooks > 1:                    # audio: [B, S, K, Vp]
        heads = params["lm_heads"].to(cfg.cdtype)
        if isinstance(xn, shd.DTensor):          # one product a codebook
            logits = torch.stack([xn.to(cfg.cdtype) @ heads[k] for k in
                                  range(cfg.num_codebooks)], 2).float()
        else:
            logits = torch.einsum("bsd,kdv->bskv", xn.to(cfg.cdtype),
                                  heads).float()
        return constrain(logits, "batch", "seq", None, "vocab")
    w = (params["embed"]["tok"].t() if cfg.tie_embeddings
         else params["lm_head"])
    logits = dense(xn, w, compute_dtype=cfg.cdtype).float()
    return constrain(logits, "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------
def _ffn_half(cfg: ModelConfig, lp, x, mode):
    """The layer's second half: ``(x + ffn(norm(x)), aux)``, the MLP's
    aux ``None``, the experts' their load-balance term."""
    xn = rmsnorm(x, lp["ln2"], cfg.norm_eps, mode=mode)
    if cfg.moe is not None:
        h, aux = moe_mod.moe_block(cfg, lp["moe"], xn)
        return x + h, aux
    return x + mlp_mod.mlp_block(cfg, lp["mlp"], xn), None


def _layer_full(cfg: ModelConfig, plan, lp, x, positions, mode):
    """One layer, full sequence. Returns (x, aux, state): aux the
    experts' load-balance term, else ``None``; state the attention's
    ``(k, v)``, RWKV's ``(wkv, last_tm, last_cm)`` or Mamba2's
    ``(conv, ssm)``."""
    if cfg.rwkv is not None:
        h, (wkv, ltm) = rwkv6.time_mix_full(
            cfg, lp["rwkv"], rmsnorm(x, lp["ln1"], cfg.norm_eps, mode=mode))
        x = x + h
        h, lcm = rwkv6.channel_mix(
            cfg, lp["rwkv"], rmsnorm(x, lp["ln2"], cfg.norm_eps, mode=mode))
        return x + h, None, (wkv, ltm, lcm)
    if cfg.ssm is not None:
        h, state = mamba2.mamba_full(
            cfg, lp["mamba"], rmsnorm(x, lp["ln1"], cfg.norm_eps, mode=mode),
            mode=mode)
        return x + h, None, state
    a, kv = attention.attend_full(
        cfg, plan, lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps, mode=mode),
        positions, mode=mode)
    x, aux = _ffn_half(cfg, lp, x + a, mode)
    return x, aux, kv


def hybrid_blocks(cfg: ModelConfig):
    """zamba2 layout: 81 = full blocks of (shared-attn + k mambas) + tail.
    Returns ``(k, full, tail)``; the shared attention runs before layer
    ``i`` when ``i % k == 0``, ``full + (tail > 0)`` times in all."""
    k = cfg.attn_every
    full, tail = cfg.num_layers // k, cfg.num_layers % k
    return k, full, tail


def _shared_before(cfg: ModelConfig, params, i: int) -> bool:
    """Whether the hybrid's shared attention runs before layer ``i``: at
    the head of each block of ``attn_every`` layers, the tail's too."""
    return bool(cfg.ssm is not None and cfg.attn_every
                and "shared_attn" in params and i % cfg.attn_every == 0)


def _shared_attn_apply(cfg: ModelConfig, plan, shared, x, positions, *,
                       mode=None):
    """The shared attention block over the full sequence: ``(x + attn(
    norm(x)), (k, v))``."""
    a, kv = attention.attend_full(
        cfg, plan, shared["attn"],
        rmsnorm(x, shared["ln"], cfg.norm_eps, mode=mode), positions,
        mode=mode)
    return x + a, kv


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device).expand(B, S)


def res_constrain(cfg: ModelConfig, x):
    """Residual-stream sharding between layers.

    With ``cfg.seq_parallel`` the sequence axis shards over 'model'
    (Megatron sequence parallelism): norms and elementwise work and the
    residual carried between layers shrink by the TP degree."""
    return constrain(x, "batch", "seq_sp" if cfg.seq_parallel else "seq",
                     None)


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
    """Full-sequence forward. Returns (logits, aux): aux is the layers'
    expert load-balance terms summed in float32 and divided by L, as the
    reference's scan sums them (0 without experts).  Under autograd each
    layer, and each application of the hybrid's shared attention, runs
    under ``cfg.remat`` as a checkpoint of its own (the reference nests
    the layers' checkpoints in one of each block; flat, each is
    recomputed once)."""
    plan = attention.plan_for(cfg)
    x = embed(cfg, params, batch)
    positions = _positions(x)

    def body(lp, x):
        x, aux, _ = _layer_full(cfg, plan, lp, x, positions, mode)
        return res_constrain(cfg, x), aux

    def shared_body(x):
        x, _ = _shared_attn_apply(cfg, plan, params["shared_attn"], x,
                                  positions, mode=mode)
        return x

    body, shared_body = _remat(cfg, body), _remat(cfg, shared_body)
    x = res_constrain(cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(_layers(params, cfg.num_layers)):
        if _shared_before(cfg, params, i):
            x = shared_body(x)
        x, a = body(lp, x)
        if a is not None:
            aux = aux + a
    return head(cfg, params, x, mode=mode), aux / cfg.num_layers


def loss_fn(cfg: ModelConfig, params, batch, aux_weight=0.01, *, mode=None):
    """Next-token cross-entropy of :func:`forward`'s logits against the
    batch's tokens, over the real vocabulary, plus ``aux_weight`` times
    the aux term: with several codebooks over every codebook's logits,
    else over the logits after the patch prefix (whose positions predict
    no token).  Returns ``(loss, {"ce", "aux"})``."""
    logits, aux = forward(cfg, params, batch, mode=mode)
    toks = _on(batch["tokens"], logits)
    lg = logits if cfg.num_codebooks > 1 else logits[:, cfg.patch_prefix:]
    ce = cross_entropy(lg[:, :-1], toks[:, 1:], real_vocab=cfg.vocab_size)
    ce, aux = shd.replicate(ce), shd.replicate(aux)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device=None):
    """Zeros: ``{"pos": 0, "k", "v": [L, B, max_len, Hkv_p, hd]}`` in the
    compute dtype for the attention families; with RWKV ``"wkv"`` ``[L,
    B, H, hd, hd]`` in float32 and ``"last_tm"`` / ``"last_cm"`` ``[L, B,
    1, D]`` in the compute dtype; with Mamba2 ``"conv"`` and ``"ssm"``
    (``mamba2.state_shapes`` under ``L``) in float32, and the hybrid's
    ``"k"`` / ``"v"`` over its ``ceil(L / attn_every)`` shared-attention
    applications.  ``pos`` is a host int."""
    dev = resolve_device(device)
    L, B, cdt, f32 = cfg.num_layers, batch_size, cfg.cdtype, torch.float32

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.rwkv is not None:
        H, hd = rwkv6.rdims(cfg)
        return {"pos": 0, "wkv": zeros((L, B, H, hd, hd), f32),
                "last_tm": zeros((L, B, 1, cfg.d_model), cdt),
                "last_cm": zeros((L, B, 1, cfg.d_model), cdt)}
    cache: dict[str, Any] = {"pos": 0}
    if cfg.ssm is not None:
        conv_s, ssm_s = mamba2.state_shapes(cfg, B)
        cache["conv"] = zeros((L,) + conv_s, f32)
        cache["ssm"] = zeros((L,) + ssm_s, f32)
    cache.update(_kv_zeros(cfg, B, max_len, dev))
    return cache


def _kv_zeros(cfg: ModelConfig, batch_size: int, max_len: int, dev) -> dict:
    """The cache's ``k`` / ``v`` zeros: one a layer, one a shared-attention
    application of the hybrid, none for RWKV or a Mamba2 stack alone.
    ``dev`` is a device, or the stream as a DTensor (the zeros then split
    by ``sharding.cache_placements``)."""
    if cfg.rwkv is not None or (cfg.ssm is not None and not cfg.attn_every):
        return {}
    napps = cfg.num_layers
    if cfg.ssm is not None:
        _, full, tail = hybrid_blocks(cfg)
        napps = full + (tail > 0)
    plan = attention.plan_for(cfg)
    shape = (napps, batch_size, max_len, plan.hkv_p, cfg.hd)
    like = dev if isinstance(dev, shd.DTensor) else torch.empty(0, device=dev)
    return {name: shd.zeros(shape, cfg.cdtype, like, name)
            for name in ("k", "v")}


def decode_step(cfg: ModelConfig, params, cache, tokens, *, mode=None):
    """One decode step. tokens: [B, 1] ([B, 1, K] with codebooks).
    Returns (logits, cache); experts route every row of the batch, as the
    reference's step does.

    The cache's ``k`` / ``v`` (the hybrid's too) are written in place at
    ``pos`` (the reference donates them to its jitted step); the returned
    dict holds the same tensors, ``pos + 1``, and the recurrent states
    (``wkv``, ``last_tm``, ``last_cm``; ``conv``, ``ssm``) as new tensors.
    Keys past ``pos`` are never read and the states given are not
    written, so a step may be taken again from the dict it was given.  A
    Mamba2 conv state of fewer than ``conv_dim - 1`` rows (a prefill of a
    shorter prompt) raises, as the reference's step does."""
    plan = attention.plan_for(cfg)
    x = embed(cfg, params, {"tokens": tokens})
    pos = cache["pos"]
    new_cache = {"pos": pos + 1}
    if "k" in cache:
        new_cache.update(k=cache["k"], v=cache["v"])
    states = []
    for i, lp in enumerate(_layers(params, cfg.num_layers)):
        if _shared_before(cfg, params, i):
            j = i // cfg.attn_every
            sh = params["shared_attn"]
            a, _, _ = attention.attend_decode(
                cfg, plan, sh["attn"],
                rmsnorm(x, sh["ln"], cfg.norm_eps, mode=mode),
                cache["k"][j], cache["v"][j], pos, mode=mode)
            x = x + a
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps, mode=mode)
        if cfg.rwkv is not None:
            h, wkv, ltm = rwkv6.time_mix_step(
                cfg, lp["rwkv"], xn, cache["wkv"][i], cache["last_tm"][i])
            x = x + h
            h, lcm = rwkv6.channel_mix(
                cfg, lp["rwkv"], rmsnorm(x, lp["ln2"], cfg.norm_eps,
                                         mode=mode), cache["last_cm"][i])
            x = x + h
            states.append((wkv, ltm.to(cfg.cdtype), lcm.to(cfg.cdtype)))
            continue
        if cfg.ssm is not None:
            h, conv, ssm = mamba2.mamba_step(
                cfg, lp["mamba"], xn, cache["conv"][i], cache["ssm"][i],
                mode=mode)
            x = x + h
            states.append((conv, ssm))
            continue
        a, _, _ = attention.attend_decode(
            cfg, plan, lp["attn"], xn, cache["k"][i], cache["v"][i], pos,
            mode=mode)
        x, _ = _ffn_half(cfg, lp, x + a, mode)
    _stack_states(cfg, states, new_cache)
    return head(cfg, params, x, mode=mode), new_cache


def _stack_states(cfg: ModelConfig, states: list, cache: dict) -> None:
    """Each layer's recurrent state, stacked into the cache's ``[L, ...]``
    leaves (none for the attention families)."""
    if not states:
        return
    names = (("wkv", "last_tm", "last_cm") if cfg.rwkv is not None
             else ("conv", "ssm"))
    for name, parts in zip(names, zip(*states), strict=True):
        cache[name] = torch.stack(parts)


def prefill(cfg: ModelConfig, params, batch, max_len: int, *, mode=None):
    """Run the prompt (``batch["tokens"]`` and, with a patch prefix,
    ``patch_embeds`` in front), build a decode cache. Returns
    (logits_last, cache).  A Mamba2 layer's conv state is its last
    ``conv_dim - 1`` input rows, or all ``S`` of a shorter prompt (the
    reference's, which its decode step then refuses)."""
    plan = attention.plan_for(cfg)
    x = embed(cfg, params, batch)
    B, S = x.shape[:2]
    positions = _positions(x)
    cache = _kv_zeros(cfg, B, max_len,
                      x if isinstance(x, shd.DTensor) else x.device)
    states = []
    for i, lp in enumerate(_layers(params, cfg.num_layers)):
        if _shared_before(cfg, params, i):
            x, (k, v) = _shared_attn_apply(cfg, plan, params["shared_attn"],
                                           x, positions, mode=mode)
            j = i // cfg.attn_every
            shd.assign(cache["k"], (j, slice(None), slice(0, S)),
                       k.to(cfg.cdtype))
            shd.assign(cache["v"], (j, slice(None), slice(0, S)),
                       v.to(cfg.cdtype))
        x, _, state = _layer_full(cfg, plan, lp, x, positions, mode)
        if cfg.rwkv is not None:
            wkv, ltm, lcm = state
            states.append((wkv, ltm.to(cfg.cdtype), lcm.to(cfg.cdtype)))
        elif cfg.ssm is not None:
            states.append(state)
        else:
            shd.assign(cache["k"], (i, slice(None), slice(0, S)),
                       state[0].to(cfg.cdtype))
            shd.assign(cache["v"], (i, slice(None), slice(0, S)),
                       state[1].to(cfg.cdtype))
    _stack_states(cfg, states, cache)
    cache["pos"] = S
    return head(cfg, params, x[:, -1:, :], mode=mode), cache
