"""Matrix product with a float32 accumulator: a hand-written Hopper kernel.

The counterpart of ``repro/kernels/matmul.py``: ``a[M, K] @ b[K, N]``,
accumulated in float32 over the k axis and cast once to ``a``'s dtype.
The wrapper keeps the reference's block arguments, clamps and refusals
(``K`` must match; ``M % bm``, ``N % bn`` and ``K % bk`` must be 0 after
the clamps, ``bm`` folding ``grain`` m-tiles); the kernels take their own
tiles.  Two kernels, chosen by :func:`route`: bfloat16 operands that TMA
can address run on the tensor cores (``csrc/matmul_tc.cu``, wgmma and
TMA, 128 x 256 tiles); every other call runs the CUDA-core kernel
(``csrc/matmul.cu``, 128 x 128 register tiles, 16-deep k slices loaded a
slice ahead into two shared buffers), which keeps float32 in full
float32.
"""
from __future__ import annotations

import torch

from repro_torch.core import _native
from repro_torch.kernels.launcher import (I, P, Launcher, check_tensors,
                                          dtype_code)

KERNEL = Launcher(symbol="launch_matmul", argtypes=(P, P, P) + (I,) * 4 + (P,),
                  source="src/repro_torch/csrc/matmul.cu")
KERNEL_TC = Launcher(symbol="launch_matmul_tc",
                     argtypes=(P, P, P) + (I,) * 3 + (P,),
                     source="src/repro_torch/csrc/matmul_tc.cu")
#: the kernel's k slice: the plain version accumulates slice by slice
K_SLICE = 16


def _check(a, b, bm, bn, bk, grain) -> torch.device:
    dev = check_tensors("matmul", a=a, b=b)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul: a [M, K] and b [K, N] expected; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: a is {a.dtype}, b is {b.dtype}")
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"matmul: a's K {K} is not b's {K2}")
    bm = min(bm * grain, M)          # grain folds m-tiles, as the reference
    bn, bk = min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"matmul: [{M}, {K}] @ [{K}, {N}] is not whole "
                         f"blocks of {bm} x {bn} x {bk}")
    return dev


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """``"tc"`` when the tensor-core kernel takes ``a @ b``, else
    ``"simt"``: both bfloat16, non-empty, and addressable by TMA (row
    strides of 16 bytes, ``K % 8 == 0`` and ``N % 8 == 0``, and data
    pointers on 16-byte boundaries; a view at an odd storage offset is
    not).  A pure function of dtypes, shapes and alignment."""
    (M, K), N = a.shape, b.shape[1]
    tc = (a.dtype == b.dtype == torch.bfloat16 and M > 0 and N > 0
          and K > 0 and K % 8 == 0 and N % 8 == 0
          and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    return "tc" if tc else "simt"


def simt_ctas(M: int, N: int) -> int:
    """The CTAs that the CUDA-core kernel's launcher starts for ``c[M,
    N]``, as its ``matmul_ctas`` gives them (builds the kernels' library
    at first use)."""
    return _native.function("matmul_ctas", (I, I))(M, N)


def matmul_plain(a, b, *, bm=128, bn=128, bk=128, grain=1):
    """The kernel's arithmetic in PyTorch: float32 products added into a
    float32 accumulator slice by slice of the k axis, then one cast."""
    _check(a, b, bm, bn, bk, grain)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], K_SLICE):
        acc.addmm_(a[:, k0:k0 + K_SLICE].float(),
                   b[k0:k0 + K_SLICE].float())
    return acc.to(a.dtype)


def matmul(a, b, *, bm=128, bn=128, bk=128, grain=1):
    """a: [M, K] @ b: [K, N] -> [M, N] in ``a``'s dtype.  Launches the
    kernel that :func:`route` picks for tensors on the card; runs
    :func:`matmul_plain` for tensors on the CPU."""
    dev = _check(a, b, bm, bn, bk, grain)
    if dev.type == "cpu":
        return matmul_plain(a, b, bm=bm, bn=bn, bk=bk, grain=grain)
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty(M, N, dtype=a.dtype, device=dev)
    if not (M and N):
        return out
    if route(a, b) == "tc":
        KERNEL_TC(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                  device=dev)
    else:
        KERNEL(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
               dtype_code("matmul", a), device=dev)
    return out
