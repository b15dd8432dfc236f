"""Dispatch for the hot-path kernels, as ``repro/kernels/ops.py``.

``mode`` selects the execution path:
  * "cuda"       - the hand-written kernel (the reference's "pallas");
                   tensors on the card, else it raises
  * "interpret"  - the kernel's plain PyTorch version, on any device
  * "ref"        - the torch oracle of ``ref``
``mode=None`` is "cuda" for tensors on the card and "interpret" for
tensors on the CPU.  Where a function has several kernels, its module's
``route`` picks one, and "interpret" runs that kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn

MODES = ("cuda", "interpret", "ref")
#: each kernel's launcher, with its count of launches; matmul and flash
#: attention pick one of theirs by ``route``
KERNELS = {"flash_attention": _fa.KERNEL,
           "flash_attention_tc": _fa.KERNEL_TC,
           "flash_decode": _fa.KERNEL_DECODE, "rmsnorm": _rn.KERNEL,
           "matmul": _mm.KERNEL, "matmul_tc": _mm.KERNEL_TC}
#: the ``KERNELS`` entry of each route
ROUTES = {"matmul": {"tc": "matmul_tc", "simt": "matmul"},
          "flash_attention": {"decode": "flash_decode",
                              "tc": "flash_attention_tc",
                              "simt": "flash_attention"}}


def default_mode(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "interpret"


def _mode(mode, t: torch.Tensor, fn: str) -> str:
    mode = mode or default_mode(t)
    if mode not in MODES:
        raise ValueError(f"{fn}: mode {mode!r} is not one of {MODES}")
    if mode == "cuda" and not t.is_cuda:
        raise ValueError(f"{fn}: mode 'cuda' launches the kernel, and the "
                         f"tensors lie on {t.device}")
    return mode


def flash_attention(q, k, v, *, causal=True, mode=None, **kw):
    """``with_lse=True`` (in ``kw``) returns ``(out, lse)`` on every
    path."""
    mode = _mode(mode, q, "flash_attention")
    if mode == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        with_lse=kw.get("with_lse", False))
    fn = _fa.flash_attention if mode == "cuda" else _fa.plain
    return fn(q, k, v, causal=causal, **kw)


def rmsnorm(x, scale, *, eps=1e-5, mode=None, **kw):
    mode = _mode(mode, x, "rmsnorm")
    if mode == "ref":
        return _ref.rmsnorm_ref(x, scale, eps)
    fn = _rn.rmsnorm if mode == "cuda" else _rn.rmsnorm_plain
    return fn(x, scale, eps=eps, **kw)


def matmul(a, b, *, mode=None, **kw):
    mode = _mode(mode, a, "matmul")
    if mode == "ref":
        return _ref.matmul_ref(a, b)
    fn = _mm.matmul if mode == "cuda" else _mm.matmul_plain
    return fn(a, b, **kw)
