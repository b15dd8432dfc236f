"""The serving tier over the port's runtime.

:mod:`repro_torch.serve.kernel_service` is the kernel-launch tier:
multi-tenant requests against registered suite kernels, batched into
stacked dispatches.  The reference's token-level LM tier
(``repro.serve.engine``) comes with the LM stack (ROADMAP 1.14).
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
