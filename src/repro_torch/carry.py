"""Carry the reference's state across: NumPy buffers -> the port's tensors.

Two kinds of state cross.  A suite entry's buffers, which its
``make_args`` builds: :func:`from_reference` hands those NumPy arrays to
the port as tensors on one device, with the names in ``const`` wrapped as
read-only ``__constant__`` buffers.  And an LM's parameters (the LM tier,
``repro_torch.models``): :func:`params_from_reference` takes the
reference's parameter pytree as NumPy arrays and gives the port's nested
dict of tensors, key for key.  bfloat16 arrays (``ml_dtypes``' type, which
``torch.from_numpy`` refuses) cross as their 16-bit patterns.

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


def params_from_reference(params, *, device=None):
    """The port's parameters for the reference's parameter pytree given as
    NumPy arrays (``jax.tree.map(np.asarray, params)``): the same nested
    keys and stacked ``[L, ...]`` layouts, each leaf a tensor on
    ``device`` (the card unless ``"cpu"`` is asked for) with the same
    dtype and bits."""
    dev = resolve_device(device)

    def carry_tree(tree):
        if isinstance(tree, dict):
            return {k: carry_tree(v) for k, v in tree.items()}
        return host_tensor(tree).to(dev)
    return carry_tree(params)
