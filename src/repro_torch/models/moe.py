"""Mixture-of-Experts: GShard-style capacity dispatch, as
``repro/models/moe.py``.

Two dispatch algorithms (``cfg.moe.dispatch``):

* ``"einsum"`` - the GShard/Switch one-hot ``[G, gs, E, C]`` dispatch and
  combine einsums;
* ``"sort"`` - a stable argsort of the chosen experts, then one gather
  into the experts' slots and one scatter back.

Plain functions on tensors: the reference's MoE is jnp, not Pallas, so
the products here are ``torch.einsum`` (cuBLAS on the card).  What has to
match the reference exactly is which expert each token goes to and which
tokens capacity drops:

* the top k gates are taken from a stable descending sort, so equal
  gates pick the lower expert first, as ``lax.top_k`` does;
* ``_einsum_moe`` gives all first choices priority over all second
  choices (``running`` across ``j``), ``_sort_moe`` goes token by token
  (a stable sort of the flattened ``[gs * k]`` choices): each mode drops
  its own tokens, as the reference's does;
* the sort path's scatters have a fixed order on any device: the slots
  are written with ``core.index.put`` (unique kept slots, dropped ones out
  of range), and each token's k contributions are added in the order of
  their places in the sorted array, the order JAX's CPU scatter-add
  applies them (``index_add_`` on CUDA has no fixed order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import index
from repro_torch.models.common import dense, silu, uniform_init
from repro_torch.models.mlp import init_mlp_params, mlp_block


def init_moe_params(gen: torch.Generator, cfg: ModelConfig):
    m = cfg.moe
    D = cfg.d_model
    p = {
        "router": uniform_init(gen, (D, m.num_experts), 1.0, torch.float32),
        "experts": {
            "w_gate": uniform_init(gen, (m.num_experts, D, m.expert_d_ff),
                                   1.0, cfg.pdtype),
            "w_up": uniform_init(gen, (m.num_experts, D, m.expert_d_ff),
                                 1.0, cfg.pdtype),
            "w_down": uniform_init(gen, (m.num_experts, m.expert_d_ff, D),
                                   1.0, cfg.pdtype),
        },
    }
    if m.num_shared:
        p["shared"] = init_mlp_params(gen, D, m.shared_d_ff * m.num_shared,
                                      cfg.pdtype)
    return p


def _capacity(group, top_k, num_experts, factor):
    c = int(group * top_k / num_experts * factor)
    return max(4, -(-c // 4) * 4)


def _expert_ffn(cfg, p, xe):
    """xe: [G, E, C, D] -> [G, E, C, D] through every expert's SwiGLU."""
    w = p["experts"]
    h = silu(torch.einsum("gecd,edf->gecf", xe,
                          w["w_gate"].to(cfg.cdtype))) * \
        torch.einsum("gecd,edf->gecf", xe, w["w_up"].to(cfg.cdtype))
    return torch.einsum("gecf,efd->gecd", h, w["w_down"].to(cfg.cdtype))


def top_k(gates, k):
    """``lax.top_k`` over the last axis: the k largest values, largest
    first, equal values in index order; ``(values, indices)``."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, p, xt):
    """xt: [G, gs, D] -> (top_w, top_idx [G, gs, k], aux)."""
    m = cfg.moe
    logits = dense(xt, p["router"], compute_dtype=torch.float32)
    gates = torch.softmax(logits, dim=-1)                    # [G, gs, E]
    top_w, top_idx = top_k(gates, m.top_k)                   # [G, gs, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    f = F.one_hot(top_idx[..., 0], m.num_experts).float().mean((0, 1))
    aux = m.num_experts * torch.sum(f * gates.mean((0, 1)))
    return top_w, top_idx, aux


def _einsum_moe(cfg, p, xt, C):
    """GShard one-hot dispatch over [G, gs, E, C] (baseline)."""
    m = cfg.moe
    G, gs, D = xt.shape
    E, dev = m.num_experts, xt.device
    top_w, top_idx, aux = _route(cfg, p, xt)
    running = torch.zeros((G, 1, E), dtype=torch.long, device=dev)
    dispatch = torch.zeros((G, gs, E, C), dtype=xt.dtype, device=dev)
    combine = torch.zeros((G, gs, E, C), dtype=torch.float32, device=dev)
    cols = torch.arange(C, device=dev)
    for j in range(m.top_k):
        oh = F.one_hot(top_idx[..., j], E)                   # [G, gs, E]
        pos = running + torch.cumsum(oh, dim=1) - oh
        keep = (pos < C) & (oh > 0)
        slot = ((pos[..., None] == cols) & keep[..., None]).to(xt.dtype)
        dispatch = dispatch + slot
        combine = combine + top_w[..., j, None, None] * slot.float()
        running = running + oh.sum(1, keepdim=True)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xt)        # [G, E, C, D]
    ye = _expert_ffn(cfg, p, xe)
    yt = torch.einsum("gtec,gecd->gtd", combine.to(cfg.cdtype),
                      ye.to(cfg.cdtype))
    return yt, aux


def _ordered_token_sum(contrib, order, gs, k, dtype):
    """``zeros([G, gs, D]).at[g, stok].add(contrib)`` with each token's k
    contributions added in the order of their places in the sorted array
    (``contrib`` is in sorted order; ``order`` is the sort's permutation
    of the token-major ``[gs * k]`` choices, so token t's places are those
    of choices ``t * k ... t * k + k - 1``)."""
    G, _, D = contrib.shape
    inv = torch.argsort(order, dim=1)           # flat choice -> sorted place
    places = inv.reshape(G, gs, k).sort(-1).values            # [G, gs, k]
    yt = torch.zeros((G, gs, D), dtype=dtype, device=contrib.device)
    for j in range(k):
        at = places[..., j, None].expand(G, gs, D)
        yt = yt + contrib.gather(1, at)
    return yt


def _sort_moe(cfg, p, xt, C):
    """Sort-based dispatch: one flat gather / scatter."""
    m = cfg.moe
    G, gs, D = xt.shape
    E, k, dev = m.num_experts, m.top_k, xt.device
    top_w, top_idx, aux = _route(cfg, p, xt)
    flat_e = top_idx.reshape(G, gs * k)
    flat_w = top_w.reshape(G, gs * k)
    flat_tok = torch.arange(gs, device=dev).repeat_interleave(k).expand(
        G, gs * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    sw = flat_w.gather(1, order)
    stok = flat_tok.gather(1, order)
    counts = F.one_hot(flat_e, E).sum(1)                     # [G, E]
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(gs * k, device=dev)[None] - starts.gather(1, se)
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)            # OOB drops
    gidx = torch.arange(G, device=dev)[:, None].expand(G, gs * k)
    gathered = xt.gather(1, stok[..., None].expand(G, gs * k, D))
    xe = index.put(torch.zeros((G, E * C, D), dtype=xt.dtype, device=dev),
                   (gidx, slot), gathered).reshape(G, E, C, D)
    ye = _expert_ffn(cfg, p, xe).reshape(G, E * C, D)
    at = torch.clamp(slot, max=E * C - 1)[..., None].expand(G, gs * k, D)
    contrib = ye.gather(1, at) * (sw * keep).to(cfg.cdtype)[..., None]
    return _ordered_token_sum(contrib, order, gs, k, cfg.cdtype), aux


def group_of(m, tokens: int) -> tuple[int, int]:
    """The dispatch group size and capacity for ``tokens`` tokens: the
    config's ``group_size`` (at most ``tokens``) halved until it divides
    them, so 66 tokens at 64 give groups of 2."""
    gs = min(m.group_size, tokens)
    while tokens % gs:
        gs //= 2
    return gs, _capacity(gs, m.top_k, m.num_experts, m.capacity_factor)


def moe_block(cfg: ModelConfig, p, x):
    """x: [B, S, D] -> (y, aux_loss)."""
    m = cfg.moe
    B, S, D = x.shape
    gs, C = group_of(m, B * S)
    xt = x.reshape(B * S // gs, gs, D)
    fn = _sort_moe if m.dispatch == "sort" else _einsum_moe
    yt, aux = fn(cfg, p, xt, C)
    y = yt.reshape(B, S, D)
    if m.num_shared:
        y = y + mlp_block(cfg, p["shared"], x)
    return y, aux
