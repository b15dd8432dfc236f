"""CuPBoP in PyTorch: the port of the JAX package ``repro`` to PyTorch and
hand-written CUDA for the NVIDIA H100.

``repro_torch.core`` mirrors ``repro.core`` module for module; the
``cuda`` backend launches the kernels of ``repro_torch/csrc/``.  The
package imports neither JAX nor the reference package.
"""
