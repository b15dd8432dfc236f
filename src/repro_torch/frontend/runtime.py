"""Runtime support for generated stage code.

Generated stages run under the same contract as hand-written ones
(:mod:`repro_torch.core.kernel`): every thread-private value that crosses
a ``__syncthreads()`` barrier must carry a leading thread-chunk axis so
the loop lowering can demote it to a ``[block_size]`` register array.
The translator wraps each carried local in :func:`carry` rather than
proving chunkedness statically - a C local initialized from ``threadIdx``
is already chunked and passes through untouched, while a scalar constant
is broadcast.

The other helpers give the generated code JAX's scalar rules where torch
differs.  A Python scalar operand is *weak*: it takes the type of the
tensor it meets (an int literal against an int32 tensor stays int32),
and where no tensor decides, an int becomes int32 and a float float32
unless :func:`repro_torch.enable_x64` is on, as JAX's do.  Scalars are
lifted onto the device of the tensor they meet, or of ``ctx.tid``:
nothing here copies a tensor between devices.

``unsigned`` values live in registers as int64 tensors holding the
32-bit pattern (``0 .. 2**32 - 1``), as the port's ``ballot`` returns
them; ``__shared__ unsigned`` arrays hold the same bits as int32.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel import UnsupportedKernel
from repro_torch.x64 import canonical_dtype, x64_enabled

#: the 32-bit pattern mask of an ``unsigned`` register
U32 = 0xFFFFFFFF


def weak_dtype(v) -> torch.dtype:
    """The type JAX gives the Python scalar ``v`` when no tensor decides."""
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, int):
        return canonical_dtype(torch.int64)
    if isinstance(v, float):
        return canonical_dtype(torch.float64)
    raise TypeError(f"not a Python scalar: {v!r}")


def _device(ctx, *vals) -> torch.device:
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return ctx.tid.device


def _lift(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.tensor(v, dtype=dtype, device=device)


def _promote(ctx, a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """``a`` and ``b`` as tensors of one type and device, with JAX's weak
    rules: a tensor decides the type, a Python scalar follows."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        dtype = torch.result_type(a, b)
        if not any(isinstance(v, torch.Tensor) and v.is_floating_point()
                   for v in (a, b)) and \
                any(isinstance(v, float) for v in (a, b)):
            dtype = tofloat_dtype()   # an integer tensor meets a float
    else:
        dtype = torch.promote_types(weak_dtype(a), weak_dtype(b))
    dev = _device(ctx, a, b)
    return _lift(a, dtype, dev), _lift(b, dtype, dev)


def cond(ctx, c) -> torch.Tensor:
    """A branch condition as a bool tensor (a constant one lifted)."""
    if isinstance(c, torch.Tensor):
        return c
    return torch.tensor(bool(c), device=ctx.tid.device)


def where(ctx, c, a, b) -> torch.Tensor:
    """``jnp.where(c, a, b)``: scalar branches follow the other's type."""
    a, b = _promote(ctx, a, b)
    return torch.where(cond(ctx, c), a, b)


def minimum(ctx, a, b) -> torch.Tensor:
    """``jnp.minimum``; torch's refuses a Python scalar operand."""
    return torch.minimum(*_promote(ctx, a, b))


def maximum(ctx, a, b) -> torch.Tensor:
    """``jnp.maximum``; torch's refuses a Python scalar operand."""
    return torch.maximum(*_promote(ctx, a, b))


def power(ctx, a, b) -> torch.Tensor:
    """``jnp.power`` over two operands of one promoted type."""
    return torch.pow(*_promote(ctx, a, b))


def unary(fn, ctx, x) -> torch.Tensor:
    """``fn`` (``torch.abs``, ``torch.exp``, ...) on a tensor or a lifted
    scalar."""
    if not isinstance(x, torch.Tensor):
        x = _lift(x, weak_dtype(x), ctx.tid.device)
    return fn(x)


def atomic_index(ctx, idx) -> torch.Tensor:
    """An atomic's target index fanned out to the thread axis: the ctx
    atomics serialise per thread and index ``idx[t]``."""
    if not isinstance(idx, torch.Tensor):
        idx = _lift(idx, weak_dtype(idx), ctx.tid.device)
    return idx.expand(ctx.tid.shape)


def u32(x) -> torch.Tensor:
    """An ``unsigned`` register: the low 32 bits of ``x``, as int64."""
    return x.long() & U32


def signed(u) -> torch.Tensor:
    """An ``unsigned`` register met by a signed 32-bit tensor: JAX
    promotes uint32 with int32 to int64, which narrows to int32 (the
    bits) unless the x64 switch is on."""
    return u if x64_enabled() else u.to(torch.int32)


def tofloat_dtype() -> torch.dtype:
    """JAX's default float type: float32, float64 under the x64 switch."""
    return canonical_dtype(torch.float64)


def tofloat(x):
    """An integer tensor met by a float scalar: its value in the default
    float type, as JAX promotes it (torch keeps float32 under the x64
    switch).  A Python int (the port's ``blockIdx``) becomes a float."""
    if not isinstance(x, torch.Tensor):
        return float(x)
    return x.to(tofloat_dtype())


def carry(val, tid):
    """Give a barrier-crossing register the leading thread-chunk axis."""
    chunk = tid.shape[0]
    if not isinstance(val, torch.Tensor):
        return torch.full((chunk,), val, dtype=weak_dtype(val),
                          device=tid.device)
    if val.dim() == 0:
        return val.reshape(1).expand(chunk).clone()
    if val.shape[0] == chunk:
        return val
    raise UnsupportedKernel(
        f"cannot carry a value of shape {tuple(val.shape)} across "
        f"__syncthreads(): expected a scalar or a leading thread-chunk "
        f"axis of {chunk}")
