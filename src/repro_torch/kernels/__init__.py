"""The hot-path kernels: matmul, RMSNorm and flash attention.

``repro_torch.kernels`` mirrors ``repro.kernels``: ``ops`` dispatches
each function to its hand-written Hopper kernel (``csrc/matmul.cu``,
``csrc/rmsnorm.cu``, ``csrc/flash_attention.cu``), to the kernel's plain
PyTorch version, or to the oracle of ``ref``.
"""
