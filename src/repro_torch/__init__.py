"""CuPBoP in PyTorch: the port of the JAX package ``repro`` to PyTorch and
hand-written CUDA for the NVIDIA H100.

``repro_torch.core`` mirrors ``repro.core`` module for module; the
``cuda`` backend launches the kernels of ``repro_torch/csrc/``.
``repro_torch.kernels`` mirrors ``repro.kernels``: matmul, RMSNorm and
flash attention, each a hand-written kernel behind ``kernels.ops``.  The
package imports neither JAX nor the reference package.
"""
