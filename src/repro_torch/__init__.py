"""CuPBoP in PyTorch: the port of the JAX package ``repro`` to PyTorch and
hand-written CUDA for the NVIDIA H100.

``repro_torch.core`` mirrors ``repro.core`` module for module; the
``cuda`` backend launches the kernels of ``repro_torch/csrc/``.
``repro_torch.kernels`` mirrors ``repro.kernels``: matmul, RMSNorm and
flash attention, each a hand-written kernel behind ``kernels.ops``.  The
package imports neither JAX nor the reference package.

64-bit types follow :func:`enable_x64`, off by default as JAX's are
(``repro_torch.x64``).
"""
from repro_torch.x64 import enable_x64

__all__ = ["enable_x64"]
