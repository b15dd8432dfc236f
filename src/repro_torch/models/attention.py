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
group_p, hd]``.

Training takes the same forward: :class:`FlashAttentionFn` (the
reference's custom VJP, ``flash_attention_trainable``) runs
``ops.flash_attention(..., with_lse=True)``, so the kernel on the card,
and keeps ``q, k, v, out, lse``; its backward is the reference's two
chunked passes in plain torch (the reference's is plain jnp, not Pallas),
``p`` recomputed from ``lse``.  :func:`flash_attention` and
:func:`_flash_fwd_lse` are the reference's chunked jnp forward as plain
torch: the oracle the tests hold the rest to.

Under a mesh, ``q``, ``k`` and ``v`` are constrained to ``("batch", "seq",
"heads", None)`` as the reference's are, and the kernel (forward and
backward) runs on each device's batch and head shards
(``sharding.local_call``); where ``Hkv`` does not divide the model axis
and ``Hq`` does, the query heads are made whole too, so that every shard
holds its queries' kv heads.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import _work_dtype, dense, rope, uniform_init
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
    q = shd.reshape(dense(x, p["wq"], p.get("bq"), cfg.cdtype),
                    B, S, plan.hq_p, hd)
    k = shd.reshape(dense(x, p["wk"], p.get("bk"), cfg.cdtype),
                    B, S, plan.hkv_p, hd)
    v = shd.reshape(dense(x, p["wv"], p.get("bv"), cfg.cdtype),
                    B, S, plan.hkv_p, hd)
    positions = shd.like_batch(positions, q)
    q = shd.local_call(rope, q, positions, cfg.rope_theta, keep=(0, 1, 2))
    k = shd.local_call(rope, k, positions, cfg.rope_theta, keep=(0, 1, 2))
    q = shd.constrain(q, "batch", "seq", "heads", None)
    k = shd.constrain(k, "batch", "seq", "heads", None)
    v = shd.constrain(v, "batch", "seq", "heads", None)
    return q, k, v


def _chunk(n: int, c: int) -> int:
    """The reference's chunk: ``c`` when it divides ``n``, else ``n``."""
    return c if n % c == 0 else n


def _flash_chunked(q, k, v, *, causal, q_chunk, kv_chunk, q_offset=0,
                   kv_len=None):
    """The reference's chunked online softmax over ``q[B, Sq, Hkv, g,
    hd]`` and ``k, v[B, Skv, Hkv, hd]``: ``(out, lse)``, out in q's dtype
    and lse ``[B, Hkv, g, Sq]``.  Scores and sums in float32 (float64 for
    float64 inputs); p is cast to v's dtype for the product with v, as the
    reference casts it."""
    B, Sq, Hkv, g, hd = q.shape
    Skv = k.shape[1]
    qc, kc = _chunk(Sq, q_chunk), _chunk(Skv, kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    wt = _work_dtype(q.dtype)
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, Sq, qc):
        qck = q[:, q0:q0 + qc].to(wt)
        gq = q_offset + q0 + torch.arange(qc, device=dev)
        m = torch.full((B, Hkv, g, qc), -math.inf, dtype=wt, device=dev)
        l = torch.zeros(B, Hkv, g, qc, dtype=wt, device=dev)
        acc = torch.zeros(B, Hkv, g, qc, hd, dtype=wt, device=dev)
        for k0 in range(0, Skv, kc):
            kck, vck = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            gk = k0 + torch.arange(kc, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qck, kck.to(wt)) * scale
            mask = torch.ones(qc, kc, dtype=torch.bool, device=dev)
            if causal:
                mask &= gq[:, None] >= gk[None, :]
            if kv_len is not None:
                mask &= (gk < kv_len)[None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            pexp = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd",
                              pexp.to(vck.dtype).to(wt), vck.to(wt))
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None])
                    .permute(0, 3, 1, 2, 4))          # [B, qc, Hkv, g, hd]
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    return torch.cat(outs, 1).to(q.dtype), torch.cat(lses, -1)


def flash_attention(q, k, v, *, causal=True, q_chunk=512, kv_chunk=1024,
                    q_offset=0, kv_len=None):
    """Chunked online-softmax attention, the reference's jnp oracle.

    q: [B, Sq, Hkv, g, hd] (grouped GQA), k/v: [B, Skv, Hkv, hd].
    Returns [B, Sq, Hkv, g, hd].  ``q_offset`` is the absolute position of
    q[0] (prefill continuation); ``kv_len`` masks a partially-filled
    cache."""
    out, _ = _flash_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                            kv_chunk=kv_chunk, q_offset=q_offset,
                            kv_len=kv_len)
    return out


def _flash_fwd_lse(q, k, v, *, causal, q_chunk, kv_chunk):
    """Same as :func:`flash_attention` but also returns the logsumexp
    ``[B, Hkv, g, Sq]``."""
    return _flash_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the chunked flash *backward*, in the kernels'
    layout: q ``[B, H, Sq, d]`` over k, v ``[B, Hkv, Skv, d]`` (query head
    ``h`` reads kv head ``h // g``).

    ``fwd(q, k, v, causal)`` gives ``(out, lse)`` with lse ``[B, H, Sq]``
    (``ops.flash_attention(..., with_lse=True)`` for the model: the kernel
    on the card).  The backward recomputes p tile by tile from lse in two
    passes over ``q_chunk`` x ``kv_chunk`` tiles - q-major for dq, kv-major
    for dk and dv, the group's heads summed into dk and dv - in float32
    (float64 for float64 inputs), as the reference's custom VJP; tiles
    wholly above the causal diagonal add exact zeros there, and are
    skipped here."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, fwd):
        out, lse = fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_chunk, kv_chunk = ctx.cfg
        B, H, Sq, hd = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        g = H // Hkv
        qc, kc = _chunk(Sq, q_chunk), _chunk(Skv, kv_chunk)
        scale = 1.0 / math.sqrt(hd)
        wt = _work_dtype(q.dtype)
        dev = q.device
        grp = (B, Hkv, g)
        qf = q.to(wt).reshape(*grp, Sq, hd)
        kf, vf = k.to(wt), v.to(wt)
        do = dout.to(wt).reshape(*grp, Sq, hd)
        lse = lse.to(wt).reshape(*grp, Sq)
        # D_i = rowsum(dout * out)
        D = (do * out.to(wt).reshape(*grp, Sq, hd)).sum(-1)

        def tile(q0, k0):
            """p and ds of the (q0, k0) tile, or None where the causal mask
            hides every pair."""
            if causal and k0 > q0 + qc - 1:
                return None
            qt, kt = qf[..., q0:q0 + qc, :], kf[:, :, None, k0:k0 + kc]
            s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
            if causal:
                gq = q0 + torch.arange(qc, device=dev)
                gk = k0 + torch.arange(kc, device=dev)
                s = torch.where(gq[:, None] >= gk[None, :], s, NEG_INF)
            p = torch.exp(s - lse[..., q0:q0 + qc, None])
            dp = torch.matmul(do[..., q0:q0 + qc, :],
                              vf[:, :, None, k0:k0 + kc].transpose(-1, -2))
            return p, p * (dp - D[..., q0:q0 + qc, None])

        # pass 1: dq (outer q, inner kv)
        dq = torch.zeros_like(qf)
        for q0 in range(0, Sq, qc):
            for k0 in range(0, Skv, kc):
                t = tile(q0, k0)
                if t is not None:
                    dq[..., q0:q0 + qc, :] += torch.matmul(
                        t[1], kf[:, :, None, k0:k0 + kc]) * scale
        # pass 2: dk / dv (outer kv, inner q), summed over the group
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        for k0 in range(0, Skv, kc):
            for q0 in range(0, Sq, qc):
                t = tile(q0, k0)
                if t is None:
                    continue
                p, ds = t
                dv[:, :, k0:k0 + kc] += torch.matmul(
                    p.transpose(-1, -2), do[..., q0:q0 + qc, :]).sum(2)
                dk[:, :, k0:k0 + kc] += torch.matmul(
                    ds.transpose(-1, -2), qf[..., q0:q0 + qc, :]
                ).sum(2) * scale
        return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def _kernel_fwd(mode):
    """``fwd`` for :class:`FlashAttentionFn`: ``ops.flash_attention`` with
    its lse, its tile arguments the whole sequence (the kernels take their
    own tiles)."""
    def fwd(q, k, v, causal):
        return ops.flash_attention(q, k, v, causal=causal, mode=mode,
                                   q_blk=q.shape[2], kv_blk=k.shape[2],
                                   with_lse=True)
    return fwd


def attend_heads(q, k, v, *, causal=True, q_chunk=512, kv_chunk=1024,
                 mode=None):
    """Attention in the kernels' layout (q ``[B, H, Sq, d]``, k, v ``[B,
    Hkv, Skv, d]``, contiguous) through ``ops.flash_attention``; inside
    :class:`FlashAttentionFn` when a gradient is asked for.  DTensors run
    shard by shard (:func:`_on_shards`)."""
    if isinstance(q, shd.DTensor):
        return _on_shards(attend_heads, q, k, v, causal=causal,
                          q_chunk=q_chunk, kv_chunk=kv_chunk, mode=mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, q_chunk, kv_chunk,
                                      _kernel_fwd(mode))
    return ops.flash_attention(q, k, v, causal=causal, mode=mode,
                               q_blk=q.shape[2], kv_blk=k.shape[2])


def _on_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` for DTensors q, k, v in the kernels' layout,
    run on each device's shards: a mesh dim keeps its split only where it
    splits the batch or the heads of all three alike, and is made whole
    elsewhere (``sharding.local_call``).  The one place where attention's
    DTensors become the plain tensors the kernels take."""
    want = [p if p.is_shard() and p.dim in (0, 1)
            and p == pk == pv else shd.Replicate()
            for p, pk, pv in zip(q.placements, k.placements, v.placements,
                                 strict=True)]

    def to(t):
        return (t if list(t.placements) == want
                else t.redistribute(t.device_mesh, want))
    return shd.local_call(fn, to(q), to(k), to(v), keep=(0, 1), **kw)


def flash_attention_trainable(q, k, v, *, causal=True, q_chunk=512,
                              kv_chunk=1024, mode=None):
    """The reference's trainable flash on its layout: q ``[B, Sq, Hkv, g,
    hd]``, k, v ``[B, Skv, Hkv, hd]``; returns ``[B, Sq, Hkv, g, hd]``.
    The forward is the kernel's (its plain version on the CPU); the
    backward :class:`FlashAttentionFn`'s."""
    B, Sq, Hkv, g, hd = q.shape
    qh = q.reshape(B, Sq, Hkv * g, hd).transpose(1, 2).contiguous()
    out = FlashAttentionFn.apply(qh, _heads_first(k), _heads_first(v),
                                 causal, q_chunk, kv_chunk, _kernel_fwd(mode))
    return out.transpose(1, 2).reshape(B, Sq, Hkv, g, hd)


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
        out = out * shd.whole_like(mask, out)[None, None, :, None]
    return dense(out.reshape(B, S, plan.hq_p * hd), p["wo"],
                 compute_dtype=cfg.cdtype)


def attend_full(cfg: ModelConfig, plan: PadPlan, p, x, positions, *,
                mode=None):
    """Full-sequence (train / prefill) attention. Returns (out, (k, v)),
    k and v ``[B, S, Hkv_p, hd]``.

    Strictly causal over the whole sequence, through :func:`attend_heads`
    (the trainable flash under autograd, over ``cfg.q_chunk`` /
    ``cfg.kv_chunk`` tiles in its backward).  The kernels take their own
    tiles, so the wrapper's tile arguments are the whole sequence (its
    default of 128 would refuse, say, a 200-token prompt)."""
    q, k, v = _project_qkv(cfg, plan, p, x, positions)
    out = attend_heads(_heads_first(q), _heads_first(k), _heads_first(v),
                       causal=True, q_chunk=cfg.q_chunk,
                       kv_chunk=cfg.kv_chunk, mode=mode)
    y = shd.constrain(_output(cfg, plan, p, out), "batch", "seq", None)
    return y, (k, v)


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
    shd.assign(k_cache, (slice(None), at), k1[:, 0].to(k_cache.dtype))
    shd.assign(v_cache, (slice(None), at), v1[:, 0].to(v_cache.dtype))
    qq = _heads_first(q)
    kk = _heads_first(k_cache[:, :kv_len])
    vv = _heads_first(v_cache[:, :kv_len])
    decode = functools.partial(ops.flash_attention, causal=False, mode=mode,
                               q_blk=1, kv_blk=kv_len)
    out = (_on_shards(decode, qq, kk, vv) if isinstance(qq, shd.DTensor)
           else decode(qq, kk, vv))
    return _output(cfg, plan, p, out), k_cache, v_cache
