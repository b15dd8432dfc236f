"""Core runtime of the port: kernel IR, lowerings, backends, launch API,
memory, streams, events and graphs, and the suite (see ``repro.core`` for
the reference)."""
from repro_torch.core.api import (
    LaunchConfig,
    compiled,
    coverage,
    launch,
    supported,
)
from repro_torch.core.backends import (
    Backend,
    UnknownBackend,
    backend_names,
    get_backend,
    register_backend,
    unregister_backend,
)
from repro_torch.core.dim3 import Dim3
from repro_torch.core.graphs import Graph, GraphError, GraphExec
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
    cuda_memcpy_async,
    cuda_memcpy_d2h,
    cuda_memcpy_h2d,
)
from repro_torch.core.streams import Event, Policy, Runtime, Stream

__all__ = [
    "WARP_SIZE", "Backend", "BlockState", "ChainStats", "ChainStep",
    "ConstArray", "Ctx", "CudaError", "DeviceBuffer", "Dim3", "Event",
    "Graph", "GraphError", "GraphExec", "KernelDef", "LaunchChain",
    "LaunchConfig", "Native", "Policy", "Runtime", "Space", "Stream",
    "UnknownBackend", "UnsupportedKernel", "backend_names", "compiled",
    "coverage", "cuda_free", "cuda_malloc", "cuda_memcpy_async",
    "cuda_memcpy_d2h", "cuda_memcpy_h2d", "get_backend", "launch",
    "register_backend", "supported", "unregister_backend",
]
