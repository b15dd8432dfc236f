"""Shared model primitives, as ``repro/models/common.py``.

Plain functions on tensors.  :func:`rmsnorm` goes through
``repro_torch.kernels.ops.rmsnorm``: the hand-written kernel for tensors
on the card, its plain version for tensors on the CPU, or what ``mode``
asks for (``ops.MODES``).  The projections stay ``torch.matmul``, as the
reference's are ``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def rmsnorm(x, scale, eps=1e-5, *, mode=None):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last axis in
    float32, in ``x``'s dtype: the stream as a contiguous ``[rows, D]``
    (the only layout the kernel takes) through ``ops.rmsnorm``."""
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    return ops.rmsnorm(rows, scale, eps=eps, mode=mode).reshape(x.shape)


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
    return (u * (2 * bound) - bound).to(dtype)
