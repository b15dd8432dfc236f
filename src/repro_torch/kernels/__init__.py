"""The hot-path kernels: matmul, RMSNorm and flash attention.

``repro_torch.kernels`` mirrors ``repro.kernels``: ``ops`` dispatches
each function to its hand-written Hopper kernel, to the kernel's plain
PyTorch version, or to the oracle of ``ref``.  matmul has two kernels
(``csrc/matmul_tc.cu`` on the tensor cores, ``csrc/matmul.cu`` on the
CUDA cores) and flash attention three (``csrc/flash_attention_tc.cu``,
``csrc/flash_decode.cu``, ``csrc/flash_attention.cu``); each module's
``route`` picks one.  RMSNorm's is ``csrc/rmsnorm.cu``.
"""
