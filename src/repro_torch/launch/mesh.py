"""Production meshes, as ``repro/launch/mesh.py``, over the default
process group.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the 'pod' axis
carries only the once-per-step gradient reduction (optionally int8
compressed, ``distributed/compression.py``); FSDP ('data') and TP
('model') stay inside a pod.

Functions, so importing this module starts no process group (the dry run
starts its fake world of 512 ranks first, ``launch.dryrun.fake_world``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding as shd


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) or (2, 16, 16) mesh over the default group's first
    256 or 512 ranks, on ``device`` (``sharding.device_type``: the card
    unless the caller asks for another; raises without a card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have == need:
        return shd.make_mesh(shape, axes, device=device)
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {have} - the dry run "
            f"must start its fake world of 512 ranks "
            f"(launch.dryrun.fake_world) before any other distributed call")
    # more ranks than needed (the 512-rank world, single-pod 256 mesh)
    return DeviceMesh(shd.device_type(device),
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *, device=None):
    """A small mesh for multi-rank tests (the group is started by the
    test's ranks), on ``device`` as :func:`make_production_mesh`: the CPU
    tests pass ``device="cpu"``."""
    return shd.make_mesh(tuple(shape), tuple(axes), device=device)
