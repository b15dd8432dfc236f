"""Cross-pod gradient compression: int8 quantized reduce + error feedback,
as ``repro/distributed/compression.py``, over c10d.

Multi-pod DP crosses the slow links once per step.  That all-reduce is
compressed: per-leaf symmetric int8 quantization (scale = max|g|/127, the
scales combined by an ``all_reduce(MAX)``), a sum in int32, dequantize,
and the quantization residual kept as an *error-feedback* accumulator
added to the next step's gradient - EF-SGD convergence semantics.  8x
fewer bytes on the slow links; the intra-pod reduce-scatter stays full
precision.

The float32 operations are the reference's, in its order, so
:func:`quantize` gives its bits (``torch.round`` rounds half to even, as
``jnp.round`` does); the residual is rounded once (:func:`_residual`), as
the reference's compiled step rounds it.  Used by
``examples/torch_compressed_dp.py``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch


def quantize(g, bits: int = 8):
    """Symmetric per-tensor quantization. Returns (q int8, scale f32)."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.max(torch.abs(g)).to(torch.float32) / qmax
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def _residual(gf, q, scale):
    """``gf - dequantize(q, scale)`` rounded once, as the reference's
    compiled step gives it (XLA fuses the product into the subtraction):
    ``q * scale`` is exact in float64 and so is its difference from
    ``gf``, which lies within a step of it."""
    return (gf.double() - q.double() * scale.double()).to(torch.float32)


def _group(group):
    """A ``ProcessGroup``, or a mesh dim's group by name on the active
    mesh (the reference's ``axis_name``)."""
    if isinstance(group, str):
        from repro_torch.distributed.sharding import active_mesh
        mesh = active_mesh()
        if mesh is None:
            raise ValueError(f"compressed_psum over {group!r}: no mesh is "
                             f"active (sharding.use_mesh)")
        return mesh.get_group(group)
    return group


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def compressed_psum(grads, group, error: Optional[Any] = None,
                    bits: int = 8):
    """Mean-reduce ``grads`` over ``group`` (a ``ProcessGroup`` or a mesh
    dim's name) with int8 + error feedback.  Every rank of the group calls
    it.  Returns (reduced, new_error)."""
    import torch.distributed as dist
    pg = _group(group)
    n = dist.get_world_size(pg)
    qmax = 2 ** (bits - 1) - 1

    def one(g, e):
        gf = g.to(torch.float32) + (0.0 if e is None else e)
        q, scale = quantize(gf, bits)
        # shared scale: max over the group so the int grid is common
        scale = scale.clone()
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=pg)
        q = torch.clamp(torch.round(gf / scale), -qmax, qmax).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=pg)
        out = total.to(torch.float32) * scale / n
        new_e = _residual(gf, q, scale)       # local residual
        return out.to(g.dtype), new_e

    flat_g = _leaves(grads)
    flat_e = _leaves(error) if error is not None else [None] * len(flat_g)
    if len(flat_e) != len(flat_g):
        flat_e = [None] * len(flat_g)
    outs = [one(g, e) for g, e in zip(flat_g, flat_e, strict=True)]
    return (_unflatten(grads, iter([o[0] for o in outs])),
            _unflatten(grads, iter([o[1] for o in outs])))


def dcn_bytes(tree, bits: int = 8) -> tuple[int, int]:
    """(compressed, fp32) cross-pod bytes per step - for the roofline."""
    n = sum(x.numel() for x in _leaves(tree))
    return n * bits // 8, n * 4
