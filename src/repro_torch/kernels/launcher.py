"""One hand-written hot-path kernel's C launcher and its launch count."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import _native

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the dtypes the kernels take, and the code their launchers read
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class Launcher:
    """``__call__`` launches the kernel on the device's current stream
    (``_native.launch``: it raises if the launcher's ``cudaError_t`` is
    not 0), then adds one to ``launches``.  ``argtypes`` end with the
    stream's."""

    symbol: str
    argtypes: tuple
    source: str
    launches: int = 0

    def __call__(self, *cargs, device: torch.device) -> None:
        _native.launch(self.symbol, self.argtypes, list(cargs), device)
        self.launches += 1


def dtype_code(name: str, t: torch.Tensor) -> int:
    """The launcher's code for ``t``'s dtype; raises for any other."""
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: {t.dtype} is not float32 or bfloat16")
    return DTYPE_CODE[t.dtype]


def check_tensors(name: str, **tensors: torch.Tensor) -> torch.device:
    """Raise unless the tensors are float32 or bfloat16, contiguous and on
    one device (the CPU or one card); returns that device."""
    for k, t in tensors.items():
        dtype_code(f"{name}: {k}", t)
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors lie on {sorted(map(str, devices))}"
                         f"; they must share one device")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev}, not the CPU or a card")
    return dev
