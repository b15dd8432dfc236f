"""Shared model primitives, as ``repro/models/common.py``.

Plain functions on tensors.  :func:`rmsnorm` goes through
``repro_torch.kernels.ops.rmsnorm``: the hand-written kernel for tensors
on the card, its plain version for tensors on the CPU, or what ``mode``
asks for (``ops.MODES``); under autograd its gradient is the plain
float32 formula's (:class:`RMSNormFn`).  The projections stay
``torch.matmul``, as the reference's are ``jnp.einsum`` outside any
Pallas kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a backward computes in: float32, or float64 for float64
    inputs (``torch.autograd.gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


class RMSNormFn(torch.autograd.Function):
    """``out = fwd(x, scale, eps)`` on ``x[rows, D]``, with the gradient
    that ``jax.grad`` takes of the reference's jnp ``rmsnorm``: in float32,
    ``n = x inv``, ``inv = rsqrt(mean(x^2) + eps)``, ``dn = g (1 +
    scale)``, ``dx = inv (dn - n mean(dn n))`` in ``x``'s dtype and
    ``dscale = sum over rows of g n`` in ``scale``'s.  ``fwd`` is
    ``ops.rmsnorm`` for the model (the kernel on the card)."""

    @staticmethod
    def forward(ctx, x, scale, eps, fwd):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        wt = _work_dtype(x.dtype)
        xf, gf = x.to(wt), g.to(wt)
        inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + ctx.eps)
        n = xf * inv
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dn = gf * (1.0 + scale.to(wt))
            dx = (inv * (dn - n * (dn * n).mean(-1, keepdim=True))
                  ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (gf * n).sum(0).to(scale.dtype)
        return dx, dscale, None, None


def rmsnorm(x, scale, eps=1e-5, *, mode=None):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last axis in
    float32, in ``x``'s dtype: the stream as a contiguous ``[rows, D]``
    (the only layout the kernel takes) through ``ops.rmsnorm``, inside
    :class:`RMSNormFn` when a gradient is asked for."""
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    fwd = functools.partial(ops.rmsnorm, mode=mode)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        out = RMSNormFn.apply(rows, scale, eps, fwd)
    else:
        out = fwd(rows, scale, eps=eps)
    return out.reshape(x.shape)


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, positions, theta=1e4):
    """NeoX-style rotary embedding. x: [..., S, H, hd]; positions: [..., S].
    The angles, cos, sin and rotation in float32; the result in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].to(torch.float32)[..., None, :] * freqs
    # ang: [..., S, 1, half] broadcasting over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], -1)
    return out.to(x.dtype)


def cross_entropy(logits, targets, mask=None, real_vocab=None):
    """Mean next-token cross-entropy in float32 over ``logits[..., Vp]``;
    the padded vocabulary past ``real_vocab`` gets ``-1e9`` added, as the
    reference adds it.  With ``mask``, the mean over its nonzero places
    (at least one)."""
    logits = logits.float()
    vp = logits.shape[-1]
    if real_vocab is not None and real_vocab < vp:
        neg = torch.zeros(vp, dtype=logits.dtype, device=logits.device)
        neg[real_vocab:] = -1e9
        logits = logits + neg
    targets = torch.as_tensor(targets, device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=logits.device).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def dense(x, w, b=None, compute_dtype=None):
    dt = compute_dtype or x.dtype
    y = torch.matmul(x.to(dt), w.to(dt))
    if b is not None:
        y = y + b.to(dt)
    return y


def uniform_init(gen: torch.Generator, shape, scale, dtype):
    """Uniform in ``[-scale / sqrt(fan_in), scale / sqrt(fan_in))``, drawn
    in float32 from ``gen`` on its device, then cast to ``dtype``.
    ``fan_in`` is ``shape[-2]`` (``shape[-1]`` for a vector)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    bound = scale / (fan_in ** 0.5)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    # in place: one float32 draw beside the result, the same roundings
    return u.mul_(2 * bound).sub_(bound).to(dtype)
