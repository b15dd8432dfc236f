"""64-bit types follow a switch, as in JAX.

JAX computes in 32 bits unless ``jax.enable_x64`` turns 64-bit types on:
with the switch off, an array made from float64, int64, uint64 or
complex128 data, and a ``jnp.zeros(..., float64)``, hold float32, int32,
uint32 and complex64.  The reference
package runs that way by default, and its float64 conformance cells turn
the switch on.  The port mirrors it: every place that makes a tensor the
reference would make as a JAX array (``carry`` for the reference's
buffers, ``memory`` for allocations and host copies, a kernel's
``__shared__`` arrays and a builder's stage-local zeros) asks
:func:`canonical_dtype`.

    with repro_torch.enable_x64():
        out, want = run_entry(entry, "vector", device="cpu")  # float64

The switch is off by default, and the context restores the state it found
on exit, also on an exception.  It is per thread (and per asyncio task),
like JAX's context manager.
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

_X64 = contextvars.ContextVar("repro_torch_x64", default=False)

_NARROW_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32,
                 torch.uint64: torch.uint32,
                 torch.complex128: torch.complex64}
_NARROW_NUMPY = {np.dtype(np.float64): np.dtype(np.float32),
                 np.dtype(np.int64): np.dtype(np.int32),
                 np.dtype(np.uint64): np.dtype(np.uint32),
                 np.dtype(np.complex128): np.dtype(np.complex64)}


def x64_enabled() -> bool:
    """Whether 64-bit types are kept (``enable_x64`` is in force)."""
    return _X64.get()


@contextlib.contextmanager
def enable_x64(new_val: bool = True):
    """Keep the 64-bit types inside the block (``new_val=False`` narrows
    them), as ``jax.enable_x64`` does; the old state returns on exit."""
    token = _X64.set(bool(new_val))
    try:
        yield
    finally:
        _X64.reset(token)


def canonical_dtype(dtype):
    """The type an array of ``dtype`` holds under the switch: float64,
    int64, uint64 and complex128 narrowed to float32, int32, uint32 and
    complex64 unless it is on.  Takes and returns a ``torch.dtype``, or a
    NumPy dtype for anything else."""
    if isinstance(dtype, torch.dtype):
        return dtype if x64_enabled() else _NARROW_TORCH.get(dtype, dtype)
    dtype = np.dtype(dtype)
    return dtype if x64_enabled() else _NARROW_NUMPY.get(dtype, dtype)
