"""RMSNorm over the rows of ``x``: a hand-written kernel for Hopper.

The counterpart of ``repro/kernels/rmsnorm.py``: in float32,
``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over each row of
``x[rows, D]``, written once in ``x``'s dtype.  ``scale`` may have another
float dtype than ``x``.  ``grain`` is the reference's rows a program: it
shrinks to a divisor of ``rows`` as there, and does not change the
kernel's launch, which gives each row one warp, or one CTA of 8 warps for
rows wider than 2,304 floats or 4,608 bfloat16s (``csrc/rmsnorm.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.core import _native
from repro_torch.kernels.launcher import (F, I, P, Launcher, check_tensors,
                                          dtype_code)

KERNEL = Launcher(symbol="launch_rmsnorm", argtypes=(P, P, P) + (I,) * 3
                  + (F, I, I, P), source="src/repro_torch/csrc/rmsnorm.cu")


def _grain(rows: int, grain: int) -> int:
    grain = max(1, min(grain, rows))
    while rows % grain:
        grain -= 1
    return grain


def ctas(rows: int, d: int, dtype: torch.dtype) -> int:
    """The CTAs that the kernel's launcher starts for ``rows`` rows of
    ``d`` elements of ``dtype`` (x's), on 16-byte boundaries, at any grain,
    as its ``rmsnorm_ctas`` gives them (builds the kernels' library at
    first use): ``rows`` on the wide path, ``ceil(rows / 8)`` otherwise."""
    return _native.function("rmsnorm_ctas", (I,) * 3)(
        rows, d, int(dtype == torch.bfloat16))


#: the launcher's paths, by the code its ``rmsnorm_path`` returns
PATHS = ("register", "wide", "two_pass")


def path(d: int, dtype: torch.dtype) -> str:
    """The path that the kernel's launcher takes for rows of ``d``
    elements of ``dtype`` on 16-byte boundaries, as its ``rmsnorm_path``
    gives it: ``"register"`` (a warp a row), ``"wide"`` (a CTA a row) or
    ``"two_pass"``."""
    return PATHS[_native.function("rmsnorm_path", (I,) * 2)(
        d, int(dtype == torch.bfloat16))]


def _check(x, scale) -> torch.device:
    dev = check_tensors("rmsnorm", x=x, scale=scale)
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x must be [rows, D] and scale [D]; got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    return dev


def rmsnorm_plain(x, scale, *, eps=1e-5, grain=8):
    """The kernel's arithmetic in PyTorch: the row's sum of squares in
    float32, ``1 / sqrt(mean + eps)``, then ``(x * inv) * (1 + scale)``
    rounded once to ``x``'s dtype."""
    _check(x, scale)
    _grain(x.shape[0], grain)
    xf = x.float()
    inv = 1.0 / torch.sqrt((xf * xf).sum(-1, keepdim=True) / x.shape[1]
                           + eps)
    return (xf * inv * (1.0 + scale.float())).to(x.dtype)


def rmsnorm(x, scale, *, eps=1e-5, grain=8):
    """x: [rows, D]; scale: [D].  Launches the kernel for tensors on the
    card; runs :func:`rmsnorm_plain` for tensors on the CPU."""
    dev = _check(x, scale)
    if dev.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps, grain=grain)
    rows, d = x.shape
    out = torch.empty_like(x)
    if rows and d:
        KERNEL(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
               _grain(rows, grain), eps, dtype_code("rmsnorm", x),
               dtype_code("rmsnorm", scale), device=dev)
    return out
