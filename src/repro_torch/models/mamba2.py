"""Mamba2 block via the chunked SSD algorithm (zamba2's substrate), as
``repro/models/mamba2.py``.

Train and prefill use the chunkwise-parallel state-space dual form: the
contributions inside a chunk are a masked ``[c, c]`` product, the state
between chunks is carried by a Python loop over the chunks (the
reference's ``lax.scan``).  What needs no carried state (the masked
product, each chunk's own state) is computed for all chunks at once, so
the loop holds two ops a chunk, and the inter-chunk term follows it; the
peak activation is ``B * S * c * H`` floats, the reference's scan body's
times the chunk count.  Decode is the O(1)-a-token recurrence over
``(conv_state, ssm_state)``.  State layout: ``[B, G, Hg, N, P]`` with
``H = G * Hg`` heads.

The reference's float32 islands are kept: the conv's input and the conv,
``softplus(dt + dt_bias)``, ``A = -exp(A_log)`` and the whole chunk scan
run in float32 whatever the compute dtype.  The chunk is ``cfg.ssm.chunk``
when it divides the sequence, else the whole sequence (the reference's
rule, which decides the rounding).  Inside a chunk the pairwise decay
``exp(cum_t - cum_i)`` is kept below the diagonal and set to 0 above it.
The reference takes ``exp`` over the full ``[c, c]`` and masks after it;
above the diagonal the exponent is a positive sum of ``dt``, which passes
float32's 88.7 at zamba2-7b's width (98-132 in its train step on an
H100), and ``jax.grad`` then carries 0 * inf = NaN through every
gradient.  The port masks the exponent before ``exp`` as well: the
forward's values are the reference's, bit for bit, and the gradient is
``jax.grad``'s wherever that is finite (ROADMAP, "Reference caveats").
The scan is plain torch, as the reference's is jnp outside any Pallas
kernel; the gated norm is :func:`~repro_torch.models.common.rmsnorm` (the
hand-written kernel on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense, rmsnorm, silu, uniform_init


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    proj = 2 * d_inner + 2 * s.ngroups * s.state_dim + H
    return d_inner, H, conv_ch, proj


def state_shapes(cfg: ModelConfig, batch):
    s = cfg.ssm
    d_inner, H, conv_ch, _ = dims(cfg)
    G, Hg = s.ngroups, H // s.ngroups
    return ((batch, s.conv_dim - 1, conv_ch),
            (batch, G, Hg, s.state_dim, s.head_dim))


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig):
    """The reference's leaves; the draws go ``in_proj``, ``conv_w``,
    ``out_proj``."""
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, conv_ch, proj = dims(cfg)
    dev, f32 = gen.device, torch.float32
    in_proj = uniform_init(gen, (D, proj), 1.0, cfg.pdtype)
    conv_w = uniform_init(gen, (s.conv_dim, conv_ch), 1.0, f32)
    out_proj = uniform_init(gen, (d_inner, D), 1.0, cfg.pdtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, dtype=f32, device=dev),
        "A_log": torch.zeros(H, dtype=f32, device=dev),
        "dt_bias": torch.zeros(H, dtype=f32, device=dev),
        "D_skip": torch.ones(H, dtype=f32, device=dev),
        "norm": torch.zeros(d_inner, dtype=f32, device=dev),
        "out_proj": out_proj,
    }


def _split_proj(cfg, zxbcdt):
    d_inner, H, conv_ch, _ = dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:]
    return z, xBC, dt


def _conv_full(p, xBC, conv_dim):
    """Causal depthwise conv via explicit shifts (kernel is tiny)."""
    S = xBC.shape[1]
    out = xBC * p["conv_w"][-1]
    for i in range(1, conv_dim):
        shifted = F.pad(xBC, (0, 0, i, 0))[:, :S]
        out = out + shifted * p["conv_w"][-1 - i]
    return silu(out + p["conv_b"])


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _grouped(cfg, xBC, dt_raw, p):
    """Split conv output into x heads [B,S,G,Hg,P], B/C [B,S,G,N], dt [B,S,G,Hg]."""
    s = cfg.ssm
    d_inner, H, _, _ = dims(cfg)
    G, Hg = s.ngroups, H // s.ngroups
    B_, S_, _ = xBC.shape
    gn = G * s.state_dim
    xs = xBC[..., :d_inner].reshape(B_, S_, G, Hg, s.head_dim)
    Bm = xBC[..., d_inner: d_inner + gn].reshape(B_, S_, G, s.state_dim)
    Cm = xBC[..., d_inner + gn:].reshape(B_, S_, G, s.state_dim)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    dt = dt.reshape(B_, S_, G, Hg)
    return xs, Bm, Cm, dt


def _gate_out(cfg, p, y, z, mode):
    """``out_proj(rmsnorm(y * silu(z)))``: the gated norm in float32."""
    y = y * silu(z.float())
    y = rmsnorm(y, p["norm"], cfg.norm_eps, mode=mode)
    return dense(y.to(cfg.cdtype), p["out_proj"], compute_dtype=cfg.cdtype)


def mamba_full(cfg: ModelConfig, p, x, state=None, *, mode=None):
    """Train/prefill forward. x: [B,S,D] -> (y, (conv_state, ssm_state)).

    ``conv_state`` is the last ``conv_dim - 1`` rows of the conv's input,
    or all ``S`` of them when the prompt is shorter (the reference's
    slice; a decode step then refuses the state, as the reference's)."""
    s = cfg.ssm
    d_inner, H, conv_ch, _ = dims(cfg)
    G, Hg = s.ngroups, H // s.ngroups
    B_, S_, D = x.shape
    c = s.chunk if S_ % s.chunk == 0 else S_
    nc = S_ // c

    zxbcdt = dense(x, p["in_proj"], compute_dtype=cfg.cdtype)
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    xBC_in = xBC.float()
    xBC = _conv_full(p, xBC_in, s.conv_dim)
    xs, Bm, Cm, dt = _grouped(cfg, xBC, dt_raw, p)
    A = -torch.exp(p["A_log"]).reshape(G, Hg)
    dA = dt * A                                                  # [B,S,G,Hg]

    def by_chunk(a):
        return a.float().reshape((B_, nc, c) + a.shape[2:])

    xs_c, B_c, C_c, dt_c = map(by_chunk, (xs, Bm, Cm, dt))
    cum = torch.cumsum(by_chunk(dA), dim=2)                  # [B,n,c,G,Hg]
    tril = torch.tril(torch.ones(c, c, dtype=torch.bool, device=x.device))
    # intra: Y[t] = sum_{i<=t} exp(cum_t - cum_i) (C_t.B_i) dt_i x_i; the
    # exponent masked before exp too, so no inf meets the mask's 0 in the
    # backward (the reference's 0 * inf = NaN)
    mask = tril[:, :, None, None]
    L = torch.exp(torch.where(mask, cum[:, :, :, None] - cum[:, :, None],
                              0.0))                          # [B,n,t,i,G,Hg]
    L = torch.where(mask, L, 0.0)
    CB = torch.einsum("bntgN,bnigN->bntig", C_c, B_c)        # [B,n,t,i,G]
    W = CB[..., None] * L * dt_c[:, :, None]                 # [B,n,t,i,G,Hg]
    y = torch.einsum("bntigh,bnighp->bntghp", W, xs_c)
    # each chunk's own state: sum_i exp(cum_last - cum_i) dt_i B_i x_i
    dte = torch.exp(cum[:, :, -1:] - cum)                    # [B,n,c,G,Hg]
    Sc = torch.einsum("bnigN,bnighp->bnghNp", B_c,
                      (dt_c * dte)[..., None] * xs_c)
    decay = torch.exp(cum[:, :, -1])[..., None, None]        # [B,n,G,Hg,1,1]
    # the scan: the state entering each chunk
    Sprev = (torch.zeros(B_, G, Hg, s.state_dim, s.head_dim,
                         dtype=torch.float32, device=x.device)
             if state is None else state.float())
    entering = []
    for n in range(nc):
        entering.append(Sprev)
        Sprev = decay[:, n] * Sprev + Sc[:, n]
    # inter: Y[t] += exp(cum_t) C_t . S_prev
    y = y + torch.einsum("bntgN,bnghNp->bntghp", C_c,
                         torch.stack(entering, 1)) * torch.exp(cum)[..., None]
    y = y + p["D_skip"].reshape(G, Hg)[None, None, None, :, :, None] * xs_c
    y = y.reshape(B_, S_, d_inner)
    out = _gate_out(cfg, p, y, z, mode)

    conv_state = xBC_in[:, -(s.conv_dim - 1):, :]
    return out, (conv_state, Sprev)


def mamba_step(cfg: ModelConfig, p, x1, conv_state, ssm_state, *,
               mode=None):
    """Decode one token. x1: [B,1,D] -> (y1, conv_state, ssm_state)."""
    s = cfg.ssm
    d_inner, H, conv_ch, _ = dims(cfg)
    G, Hg = s.ngroups, H // s.ngroups
    B_ = x1.shape[0]
    zxbcdt = dense(x1, p["in_proj"], compute_dtype=cfg.cdtype)
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    window = torch.cat([conv_state, xBC.float()], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC1 = silu(conv)[:, None, :]
    xs, Bm, Cm, dt = _grouped(cfg, xBC1, dt_raw, p)
    A = -torch.exp(p["A_log"]).reshape(G, Hg)
    dA1 = torch.exp(dt[:, 0] * A)                                # [B,G,Hg]
    xf = xs[:, 0]                                                # [B,G,Hg,P]
    Bf, Cf = Bm[:, 0], Cm[:, 0]                                  # [B,G,N]
    ssm_state = (dA1[..., None, None] * ssm_state
                 + (dt[:, 0, :, :, None, None] * Bf[:, :, None, :, None])
                 * xf[:, :, :, None, :])
    y = torch.einsum("bgN,bghNp->bghp", Cf, ssm_state) \
        + p["D_skip"].reshape(G, Hg)[None, :, :, None] * xf
    y = y.reshape(B_, 1, d_inner)
    return _gate_out(cfg, p, y, z, mode), window[:, 1:], ssm_state
