"""RWKV6 "Finch" block: data-dependent per-channel decay linear attention,
as ``repro/models/rwkv6.py``.

Train and prefill use a chunked parallel form: within a chunk the pairwise
per-channel decay ``exp(lw_{t-1} - lw_i)`` is applied through rescaled
r~ / k~ vectors, clamped symmetrically at ``LOG_CLAMP`` (below which the
true factor is ~0), under a strictly lower mask; the ``[B, H, K, V]`` state
between chunks is carried by a Python loop over the chunks (the
reference's ``lax.scan``).  What needs no carried state is computed for
all chunks at once (as in :mod:`repro_torch.models.mamba2`), and the loop
holds two ops a chunk.  Decode is the exact recurrence
``S_t = diag(w_t) S_{t-1} + k_t^T v_t``,
``y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``.

Everything here is plain torch, as the reference's is jnp outside any
Pallas kernel.  :func:`_head_norm` normalises each head and scales by the
``D``-wide ``ln_x``: the reference's own jnp, not ``common.rmsnorm``, so
the RMSNorm kernel (one ``[D]`` scale over one row) does not take it.

Under a mesh the time mix's projections, chunk scan and head norm (no
DTensor sharding rule for the chunked form) run on each device's batch
rows with their parameters made whole (``sharding.local_call``); ``wo``
and the channel mix are DTensor products, constrained where the
reference constrains them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import dense, silu, uniform_init

LOG_CLAMP = -40.0


def rdims(cfg: ModelConfig):
    hd = cfg.rwkv.head_dim
    H = cfg.d_model // hd
    return H, hd


def init_rwkv_params(gen: torch.Generator, cfg: ModelConfig):
    """The reference's leaves; the draws go ``rkvg``, ``w1``, ``w2``,
    ``wo``, ``cm_k``, ``cm_v``, ``cm_r``."""
    D, F = cfg.d_model, cfg.d_ff
    H, hd = rdims(cfg)
    dl = cfg.rwkv.decay_lora
    dev, f32, pdt = gen.device, torch.float32, cfg.pdtype
    drawn = {name: uniform_init(gen, shape, scale, pdt) for name, shape, scale
             in (("rkvg", (D, 4 * D), 1.0), ("w1", (D, dl), 1.0),
                 ("w2", (dl, D), 0.1), ("wo", (D, D), 1.0),
                 ("cm_k", (D, F), 1.0), ("cm_v", (F, D), 1.0),
                 ("cm_r", (D, D), 1.0))}
    return {
        "mu": torch.full((6, D), 0.5, dtype=f32, device=dev),
        "rkvg": drawn["rkvg"],
        "w_base": torch.full((D,), -1.0, dtype=f32, device=dev),
        "w1": drawn["w1"],
        "w2": drawn["w2"],
        "u": torch.zeros(H, hd, dtype=f32, device=dev),
        "ln_x": torch.zeros(D, dtype=f32, device=dev),
        "wo": drawn["wo"],
        # channel mix
        "cm_k": drawn["cm_k"],
        "cm_v": drawn["cm_v"],
        "cm_r": drawn["cm_r"],
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros or ``last`` [B,1,D] at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last.to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xprev, mu):
    return x + (xprev - x) * mu


def _rkvgw(cfg, p, x, xprev):
    """Project token-shift-mixed inputs to r,k,v,g [B,S,H,hd] and logw [B,S,H,hd]."""
    B_, S_, D = x.shape
    H, hd = rdims(cfg)
    mu = p["mu"]
    rkvg = dense(_mix(x, xprev, mu[0]), p["rkvg"], compute_dtype=cfg.cdtype)
    r, k, v, g = torch.chunk(rkvg, 4, dim=-1)
    xw = _mix(x, xprev, mu[4]).float()
    lora = torch.tanh(xw @ p["w1"].float()) @ p["w2"].float()
    logw = -torch.exp(p["w_base"] + lora)        # log decay, in (-inf, 0)
    rs = r.reshape(B_, S_, H, hd).float()
    ks_ = k.reshape(B_, S_, H, hd).float()
    vs = v.reshape(B_, S_, H, hd).float()
    return rs, ks_, vs, silu(g.float()), logw.reshape(B_, S_, H, hd)


def _head_norm(cfg, y, p):
    B_, S_, H, hd = y.shape
    yf = y.float()
    var = (yf * yf).mean(-1, keepdim=True)
    yn = yf * torch.rsqrt(var + cfg.norm_eps)
    return yn.reshape(B_, S_, H * hd) * (1.0 + p["ln_x"])


#: the time mix's parameters that its local part reads
_CORE = ("mu", "rkvg", "w1", "w2", "w_base", "u", "ln_x")


def _core(p) -> dict:
    return {k: p[k] for k in _CORE}


def time_mix_full(cfg: ModelConfig, p, x, state=None, last=None):
    """x: [B,S,D] -> (y, (wkv_state [B,H,hd,hd], last_token [B,1,D]))."""
    xprev = _shift(x, last)
    y, Sprev = shd.local_call(_time_mix_chunks, cfg, _core(p), x, xprev,
                              state, keep=(0,), out_like=2, whole=(1,))
    out = dense(y.to(cfg.cdtype), p["wo"], compute_dtype=cfg.cdtype)
    return constrain(out, "batch", "seq", None), (Sprev, x[:, -1:, :])


def _time_mix_chunks(cfg: ModelConfig, p, x, xprev, state):
    """The time mix before ``wo``: ``(y, final state)``."""
    B_, S_, D = x.shape
    H, hd = rdims(cfg)
    c = cfg.rwkv.chunk if S_ % cfg.rwkv.chunk == 0 else S_
    nc = S_ // c
    r, k, v, g, logw = _rkvgw(cfg, p, x, xprev)
    u = p["u"]

    def by_chunk(a):
        return a.reshape((B_, nc, c) + a.shape[2:])

    rn, kn, vn, lwn = map(by_chunk, (r, k, v, logw))         # [B,n,c,H,hd]
    lcum = torch.cumsum(lwn, dim=2)                  # inclusive log-decay sum
    lprev = lcum - lwn                               # lcum_{t-1}
    # pairwise decay exp(lprev_t - lcum_i) realized as r~_t . k~_i; the
    # symmetric clamp at LOG_CLAMP keeps both factors finite while pairs
    # whose true product is > exp(LOG_CLAMP) stay exact (lcum monotone)
    rt = rn * torch.exp(torch.clamp(lprev, min=LOG_CLAMP))
    kt = kn * torch.exp(torch.clamp(-lcum, max=-LOG_CLAMP))
    A = torch.einsum("bnthd,bnihd->bnhti", rt, kt)  # [B,n,H,t,i]
    # strictly lower: i < t
    tril = torch.tril(torch.ones(c, c, dtype=torch.bool, device=x.device),
                      diagonal=-1)
    A = torch.where(tril, A, 0.0)
    y = torch.einsum("bnhti,bnihd->bnthd", A, vn)
    # diag bonus: y_t += (r_t . (u*k_t)) v_t
    diag = (rn * u * kn).sum(-1)
    y = y + diag[..., None] * vn
    # each chunk's own state: sum_i (k_i * exp(lcum_last - lcum_i)) x v_i
    dece = torch.exp(lcum[:, :, -1:] - lcum)         # <= 1 elementwise
    Sc = torch.einsum("bnihk,bnihv->bnhkv", kn * dece, vn)
    decay = torch.exp(lcum[:, :, -1])[..., None]     # [B,n,H,hd,1]
    # the scan: S_new = diag(exp(lcum_last)) S_prev + the chunk's own
    Sprev = (torch.zeros(B_, H, hd, hd, dtype=torch.float32, device=x.device)
             if state is None else state.float())
    entering = []
    for n in range(nc):
        entering.append(Sprev)
        Sprev = decay[:, n] * Sprev + Sc[:, n]
    # inter-chunk: y_t += (r_t * exp(lprev_t)) . S_prev
    y = y + torch.einsum("bnthk,bnhkv->bnthv", rt, torch.stack(entering, 1))
    y = y.reshape(B_, S_, H, hd)
    return _head_norm(cfg, y, p) * g.reshape(B_, S_, D), Sprev


def time_mix_step(cfg: ModelConfig, p, x1, state, last):
    """Decode one token. Returns (y1, state, new_last)."""
    y, state = shd.local_call(_time_mix_token, cfg, _core(p), x1,
                              last.to(x1.dtype), state, keep=(0,),
                              out_like=2, whole=(1,))
    out = dense(y.to(cfg.cdtype), p["wo"], compute_dtype=cfg.cdtype)
    return out, state, x1[:, -1:, :]


def _time_mix_token(cfg: ModelConfig, p, x1, last, state):
    """One token's time mix before ``wo``: ``(y1, state)``."""
    B_ = x1.shape[0]
    H, hd = rdims(cfg)
    r, k, v, g, logw = _rkvgw(cfg, p, x1, last)
    r1, k1, v1, lw1 = (a[:, 0].reshape(B_, H, hd) for a in (r, k, v, logw))
    kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
    y = torch.einsum("bhk,bhkv->bhv", r1,
                     state + p["u"][None, :, :, None] * kv)
    state = torch.exp(lw1)[..., None] * state + kv
    y = y.reshape(B_, 1, H, hd)
    return _head_norm(cfg, y, p) * g.reshape(B_, 1, -1), state


def channel_mix(cfg: ModelConfig, p, x, last=None):
    """RWKV channel mix. Returns (y, new_last)."""
    xprev = _shift(x, last)
    mu = p["mu"]
    xk = _mix(x, xprev, mu[5])
    xr = _mix(x, xprev, mu[3])
    k = torch.square(torch.relu(dense(xk, p["cm_k"],
                                      compute_dtype=cfg.cdtype)))
    k = constrain(k, "batch", "seq", "tp")
    v = dense(k, p["cm_v"], compute_dtype=cfg.cdtype)
    r = torch.sigmoid(dense(xr, p["cm_r"], compute_dtype=cfg.cdtype).float())
    return (r * v.float()).to(x.dtype), x[:, -1:, :]
