"""Carry the reference's state across: NumPy buffers -> the port's tensors.

This system runs kernels, not a model, so its "weights" are the buffers a
suite entry's ``make_args`` builds.  :func:`from_reference` hands those
NumPy arrays to the port as tensors on one device, with the names in
``const`` wrapped as read-only ``__constant__`` buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.memory import ConstArray, resolve_device

# JAX runs with 64-bit types disabled, so the reference computes in 32 bits
# whatever NumPy handed it; the port does the same.
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def from_reference(args: dict[str, np.ndarray], *, const=(),
                   device=None) -> dict:
    """Tensors on ``device`` (the card unless ``"cpu"`` is asked for) for
    the reference's NumPy buffers; ``const`` names become ConstArrays."""
    dev = resolve_device(device)
    out = {}
    for name, value in args.items():
        arr = np.asarray(value)
        arr = np.ascontiguousarray(arr.astype(_NARROW.get(arr.dtype,
                                                          arr.dtype)))
        t = torch.from_numpy(arr).to(dev)
        out[name] = ConstArray(t) if name in const else t
    return out
