"""Serving tiers over the port's runtime.

Two granularities share the emit-on-hazard discipline:

* :mod:`repro_torch.serve.kernel_service` - the kernel-launch tier:
  multi-tenant requests against registered suite kernels, batched into
  stacked dispatches;
* :mod:`repro_torch.serve.engine` - the token-level LM tier:
  continuous-batching decode over the dense decoder
  (``repro_torch.models``), whose RMSNorm and attention launch the
  hand-written kernels on the card (imported lazily; it pulls in the
  model code, which kernel-serving users never need).
"""
from repro_torch.serve.kernel_service import (
    Endpoint,
    KernelService,
    ServeTicket,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    ServiceStats,
    ServiceTimeout,
)

__all__ = [
    "Endpoint", "KernelService", "ServeTicket", "ServiceClosed",
    "ServiceError", "ServiceOverloaded", "ServiceStats", "ServiceTimeout",
]
