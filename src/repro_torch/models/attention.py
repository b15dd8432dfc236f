"""GQA attention, as ``repro/models/attention.py``: padded-TP projections,
full-sequence (prefill) attention and one-token decode against a cache.

The reference's model attention is its chunked flash in plain jnp, "the
pure-JAX oracle of the Pallas kernel"; here both calls go through
``repro_torch.kernels.ops.flash_attention``, so on the card they launch
the hand-written kernel that ``kernels.flash_attention.route`` picks
(``csrc/flash_attention_tc.cu`` for a bfloat16 prefill,
``csrc/flash_decode.cu`` for a decode step or a prefill of at most 8 rows
a kv group, ``csrc/flash_attention.cu`` for a float32 prefill) and on the
CPU its plain version.  The kernels take ``q[B, Hq_p, S, hd]`` over
contiguous ``k, v[B, Hkv_p, Skv, hd]``; query head ``h`` reads kv head
``h // group_p``, the reference's grouping of q as ``[B, S, Hkv_p,
group_p, hd]``.  The trainable flash (the reference's custom VJP) comes
with the training path.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense, rope, uniform_init
from repro_torch.models.padding import PadPlan, gqa_pad_plan


def plan_for(cfg: ModelConfig) -> PadPlan:
    return gqa_pad_plan(cfg.num_heads, cfg.num_kv_heads, cfg.tp_align)


def init_attn_params(gen: torch.Generator, cfg: ModelConfig,
                     plan: PadPlan | None = None):
    """The dummy heads' slots are zeroed so padding is exactly inert; the
    weights keep ``cfg.pdtype`` (the reference's product with a float32
    NumPy mask promotes the masked bfloat16 weights to float32, with the
    same values)."""
    plan = plan or plan_for(cfg)
    D, hd = cfg.d_model, cfg.hd
    dt, dev = cfg.pdtype, gen.device
    p = {
        "wq": uniform_init(gen, (D, plan.hq_p * hd), 1.0, dt),
        "wk": uniform_init(gen, (D, plan.hkv_p * hd), 1.0, dt),
        "wv": uniform_init(gen, (D, plan.hkv_p * hd), 1.0, dt),
        "wo": uniform_init(gen, (plan.hq_p * hd, D), 1.0, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(plan.hq_p * hd, dtype=dt, device=dev)
        p["bk"] = torch.zeros(plan.hkv_p * hd, dtype=dt, device=dev)
        p["bv"] = torch.zeros(plan.hkv_p * hd, dtype=dt, device=dev)
    # zero the dummy slots so padding is exactly inert
    if not plan.is_identity:
        qm = torch.tensor(plan.qmap) < 0
        kvm = torch.tensor(plan.kvmap) < 0
        if qm.any():
            z = _slot_mask(qm, hd, dt, dev)
            p["wq"] = p["wq"] * z
            p["wo"] = p["wo"] * z.reshape(-1, 1)
        if kvm.any():
            z = _slot_mask(kvm, hd, dt, dev)
            p["wk"] = p["wk"] * z
            p["wv"] = p["wv"] * z
    return p


def _slot_mask(dummy: torch.Tensor, hd: int, dtype, device) -> torch.Tensor:
    """1 for each column of a real head, 0 for a dummy head's, flat."""
    z = torch.ones(len(dummy), hd, dtype=dtype)
    z[dummy] = 0
    return z.reshape(-1).to(device)


def _project_qkv(cfg: ModelConfig, plan: PadPlan, p, x, positions):
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(x, p["wq"], p.get("bq"), cfg.cdtype).reshape(B, S, plan.hq_p, hd)
    k = dense(x, p["wk"], p.get("bk"), cfg.cdtype).reshape(B, S, plan.hkv_p, hd)
    v = dense(x, p["wv"], p.get("bv"), cfg.cdtype).reshape(B, S, plan.hkv_p, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads_first(t):
    """``[B, S, H, hd]`` -> a contiguous ``[B, H, S, hd]``, the kernels'
    layout."""
    return t.transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _head_mask(mask: tuple, dtype, device) -> torch.Tensor:
    """The plan's head mask on ``device``, made once: a host tensor copied
    to the card at every layer would sync the host each time."""
    return torch.tensor(mask, dtype=dtype).to(device)


def _output(cfg: ModelConfig, plan: PadPlan, p, out):
    """The kernel's ``[B, Hq_p, S, hd]`` back to ``[B, S, Hq_p, hd]``, the
    dummy heads masked (a zeroed q still gets the mean of v), then
    ``wo``."""
    B, _, S, hd = out.shape
    out = out.transpose(1, 2)
    if not all(plan.head_mask):
        mask = _head_mask(plan.head_mask, out.dtype, out.device)
        out = out * mask[None, None, :, None]
    return dense(out.reshape(B, S, plan.hq_p * hd), p["wo"],
                 compute_dtype=cfg.cdtype)


def attend_full(cfg: ModelConfig, plan: PadPlan, p, x, positions, *,
                mode=None):
    """Full-sequence (prefill) attention. Returns (out, (k, v)), k and v
    ``[B, S, Hkv_p, hd]``.

    Strictly causal over the whole sequence.  The kernels take their own
    tiles, so the wrapper's tile arguments are the whole sequence (its
    default of 128 would refuse, say, a 200-token prompt)."""
    S = x.shape[1]
    q, k, v = _project_qkv(cfg, plan, p, x, positions)
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=True, mode=mode,
                              q_blk=S, kv_blk=S)
    return _output(cfg, plan, p, out), (k, v)


def attend_decode(cfg: ModelConfig, plan: PadPlan, p, x1, k_cache, v_cache,
                  pos: int, *, mode=None):
    """One-token decode against a cache. Returns (out, k_cache, v_cache).

    x1: [B, 1, D]; caches [B, Smax, Hkv_p, hd], written in place at
    ``pos``, a host int (a device scalar would sync the host at every
    slice).  The reference attends over the whole cache with keys past
    ``pos`` masked; the kernel takes a contiguous copy of the first
    ``pos + 1`` keys and values, non-causal.  Past the cache's end the
    reference's ``dynamic_update_slice`` clamps its start, so the step
    writes row ``Smax - 1`` and attends to every row; so does this one."""
    B, Smax = x1.shape[0], k_cache.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x1.device)
    q, k1, v1 = _project_qkv(cfg, plan, p, x1, positions)
    at, kv_len = min(pos, Smax - 1), min(pos + 1, Smax)
    k_cache[:, at] = k1[:, 0].to(k_cache.dtype)
    v_cache[:, at] = v1[:, 0].to(v_cache.dtype)
    kk = _heads_first(k_cache[:, :kv_len])
    vv = _heads_first(v_cache[:, :kv_len])
    out = ops.flash_attention(_heads_first(q), kk, vv, causal=False,
                              mode=mode, q_blk=1, kv_blk=kv_len)
    return _output(cfg, plan, p, out), k_cache, v_cache
