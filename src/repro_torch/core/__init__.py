"""Core runtime of the port: kernel IR, lowerings, backends, launch API,
memory, and the suite (see ``repro.core`` for the reference)."""
from repro_torch.core.api import LaunchConfig, compiled, launch
from repro_torch.core.backends import backend_names, register_backend
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import (
    WARP_SIZE,
    BlockState,
    ChainStats,
    ChainStep,
    Ctx,
    KernelDef,
    LaunchChain,
    Native,
    UnsupportedKernel,
)
from repro_torch.core.memory import (
    ConstArray,
    CudaError,
    DeviceBuffer,
    Space,
    cuda_free,
    cuda_malloc,
    cuda_memcpy_d2h,
    cuda_memcpy_h2d,
)

__all__ = [
    "WARP_SIZE", "BlockState", "ChainStats", "ChainStep", "ConstArray",
    "Ctx", "CudaError", "DeviceBuffer", "Dim3", "KernelDef",
    "LaunchChain", "LaunchConfig", "Native", "Space", "UnsupportedKernel",
    "backend_names", "compiled", "cuda_free", "cuda_malloc",
    "cuda_memcpy_d2h", "cuda_memcpy_h2d", "launch", "register_backend",
]
