"""Core runtime of the port: kernel IR, lowerings, backends, launch API,
memory, streams, events and graphs, and the suite (see ``repro.core`` for
the reference)."""
from repro_torch.core.api import (
    CacheStats,
    LaunchConfig,
    cache_clear,
    cache_resize,
    cache_size,
    cache_stats,
    compiled,
    coverage,
    disable_disk_cache,
    enable_disk_cache,
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
    CompiledKernel,
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
    UnsupportedSpace,
    cuda_free,
    cuda_malloc,
    cuda_memcpy_async,
    cuda_memcpy_d2h,
    cuda_memcpy_h2d,
    cuda_memcpy_to_symbol,
)
from repro_torch.core.streams import Event, Policy, Runtime, Stream



def __getattr__(name):
    if name == "BACKENDS":  # a live view of the registry
        return backend_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BACKENDS", "Backend", "BlockState", "CacheStats", "ChainStats",
    "ChainStep", "CompiledKernel", "ConstArray", "Ctx", "CudaError",
    "DeviceBuffer", "Dim3", "Event", "Graph", "GraphError", "GraphExec",
    "KernelDef", "LaunchChain", "LaunchConfig", "Native", "Policy",
    "Runtime", "Space", "Stream", "UnknownBackend", "UnsupportedKernel",
    "UnsupportedSpace", "WARP_SIZE", "backend_names", "cache_clear",
    "cache_resize", "cache_size", "cache_stats", "compiled", "coverage",
    "cuda_free", "cuda_malloc", "cuda_memcpy_async", "cuda_memcpy_d2h",
    "cuda_memcpy_h2d", "cuda_memcpy_to_symbol", "disable_disk_cache",
    "enable_disk_cache", "get_backend", "launch", "register_backend",
    "supported", "unregister_backend",
]
