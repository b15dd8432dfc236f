"""Carry the reference's state across: NumPy buffers -> the port's tensors.

This system runs kernels, not a model, so its "weights" are the buffers a
suite entry's ``make_args`` builds.  :func:`from_reference` hands those
NumPy arrays to the port as tensors on one device, with the names in
``const`` wrapped as read-only ``__constant__`` buffers.  The hot-path
kernels' activations may be bfloat16 (``ml_dtypes``' type, which
``torch.from_numpy`` refuses): they cross as their 16-bit patterns.

float64 and int64 buffers follow the port's x64 switch
(:func:`repro_torch.enable_x64`), as JAX's arrays follow its own: off,
the default, they cross as float32 and int32, as the reference computes
in 32 bits whatever NumPy handed it; on, they keep their 64 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.memory import ConstArray, resolve_device
from repro_torch.x64 import canonical_dtype


def _is_bfloat16(dtype: np.dtype) -> bool:
    # ml_dtypes' bfloat16, recognised without importing ml_dtypes
    return dtype.name == "bfloat16" and dtype.itemsize == 2


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values (bfloat16 bit for bit)."""
    if _is_bfloat16(arr.dtype):
        bits = np.ascontiguousarray(arr).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    # astype copies: the tensors never share memory with the caller's arrays
    return torch.from_numpy(np.ascontiguousarray(
        arr.astype(canonical_dtype(arr.dtype))))


def from_reference(args: dict[str, np.ndarray], *, const=(),
                   device=None) -> dict:
    """Tensors on ``device`` (the card unless ``"cpu"`` is asked for) for
    the reference's NumPy buffers; ``const`` names become ConstArrays."""
    dev = resolve_device(device)
    out = {}
    for name, value in args.items():
        t = _tensor(np.asarray(value)).to(dev)
        out[name] = ConstArray(t) if name in const else t
    return out
