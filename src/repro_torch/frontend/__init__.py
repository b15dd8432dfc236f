"""CUDA-C source frontend of the port: parse real ``.cu`` kernels into
``KernelDef``.

The counterpart of ``repro.frontend``.  The paper's headline claim is
executing CUDA *as written* - no manual modification.  This package lexes,
parses, and translates the restricted CUDA-C subset the suite models into
the same ``KernelDef(stages=...)`` IR the port's lowerings consume,
splitting kernel bodies at ``__syncthreads()`` barriers exactly as the
loop-fission lowerings expect (paper SIII-B.3); the generated stages are
torch code.

Supported subset (see ``docs/frontend.md`` for the full table):

* ``__global__ void`` kernels with pointer and bound-scalar parameters;
* ``__shared__`` / ``extern __shared__`` / file-scope ``__constant__``
  declarations, mapped to the ``KernelDef.shared`` spec and the global
  heap;
* ``threadIdx`` / ``blockIdx`` / ``blockDim`` / ``gridDim`` members;
* ``__syncthreads()`` (stage split), ``__syncthreads_count``;
* ``atomicAdd/Max/Min/CAS/Exch`` on global buffers;
* ``__shfl_sync`` / ``__shfl_up/down/xor_sync`` / ``__ballot_sync`` /
  ``__all_sync`` / ``__any_sync`` warp intrinsics;
* ``if``/``else``, constant-trip ``for`` loops, ``int``/``float``
  locals, ternaries, and the usual C operators.

Out-of-subset constructs raise
:class:`~repro_torch.core.kernel.UnsupportedKernel` with the offending
source line - the frontend analogue of a Table-II 'unsupport' cell, never
a silent mistranslation.  The translation is *bit-faithful*: conditional
stores lower to the suite's out-of-bounds-sentinel masked scatter, so
ingested kernels are bit-identical to their hand-written twins (the
``mode="frontend"`` cells of the conformance matrix enforce this).  A
translated kernel has no hand-written CUDA kernel: the ``cuda`` backend
refuses it, and it runs on ``loop`` and ``vector`` on the buffers'
device, the card included.
"""
from repro_torch.frontend.translate import TranslatedKernel, translate

__all__ = ["translate", "TranslatedKernel"]
