"""Carry the reference's state across: NumPy buffers -> the port's tensors.

This system runs kernels, not a model, so its "weights" are the buffers a
suite entry's ``make_args`` builds.  :func:`from_reference` hands those
NumPy arrays to the port as tensors on one device, with the names in
``const`` wrapped as read-only ``__constant__`` buffers.  The hot-path
kernels' activations may be bfloat16 (``ml_dtypes``' type, which
``torch.from_numpy`` refuses): they cross as their 16-bit patterns.

64-bit buffers (float64, int64, uint64, complex128) follow the port's x64
switch (:func:`repro_torch.enable_x64`), as JAX's arrays follow its own:
off, the default, they cross in 32 bits (complex64 for complex128), as
the reference computes whatever NumPy handed it; on, they keep their 64.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.memory import ConstArray, host_tensor, resolve_device


def from_reference(args: dict[str, np.ndarray], *, const=(),
                   device=None) -> dict:
    """Tensors on ``device`` (the card unless ``"cpu"`` is asked for) for
    the reference's NumPy buffers; ``const`` names become ConstArrays."""
    dev = resolve_device(device)
    out = {}
    for name, value in args.items():
        t = host_tensor(value).to(dev)
        out[name] = ConstArray(t) if name in const else t
    return out
