"""CUDA memory spaces and tracked device buffers, on torch tensors.

| CUDA space       | the port                                         |
|------------------|--------------------------------------------------|
| global           | a torch tensor on the card (or the CPU in tests) |
| shared           | ``KernelDef.shared`` (real ``__shared__`` under ``cuda``) |
| local/registers  | thread-private tensors / registers               |
| constant         | :class:`ConstArray`: read-only at the Python level |
| texture          | unsupported (Table II)                           |

``CONST`` buffers are read by the ``cuda`` backend's kernels through
``const T* __restrict__`` pointers, not the hardware's 64 KB
``__constant__`` bank: Rodinia-size inputs (24 MB of BFS edges) do not
fit there.  Read-only-ness is enforced here, on the one launch path every
backend shares (:func:`resolve_launch_args`).

A :class:`DeviceBuffer` carries an allocation id and a live/freed state;
``cuda_free`` invalidates it, and any later use raises :class:`CudaError`
(``cudaErrorInvalidValue``).

Every entry point that allocates takes ``device=``; left ``None`` it is
the card, and with no card it raises - the port never falls back to the
CPU unless the caller asks for it (:func:`resolve_device`).
"""
from __future__ import annotations

import enum
import itertools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise.

    ``None`` means ``cuda`` and raises when no card is present; an
    explicit ``"cpu"`` is honoured, an explicit CUDA device is checked.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           f"available")
    return dev


class Space(enum.Enum):
    GLOBAL = "global"
    SHARED = "shared"
    LOCAL = "local"
    CONST = "const"
    TEXTURE = "texture"   # unsupported, as in the paper


class UnsupportedSpace(Exception):
    pass


class CudaError(Exception):
    """``cudaErrorInvalidValue`` analogue: an invalid-handle operation."""


_ALLOC_IDS = itertools.count(1)


class ConstArray:
    """A ``__constant__``-space buffer: a read-only tensor.

    Kernels may read it like any global buffer; binding it to a buffer
    named in ``KernelDef.writes`` raises :class:`UnsupportedSpace`.
    """

    __slots__ = ("value",)

    def __init__(self, value: torch.Tensor):
        object.__setattr__(self, "value", value)

    def __setattr__(self, name, _value):
        raise UnsupportedSpace(f"ConstArray is read-only (tried to set "
                               f"{name!r})")

    @property
    def shape(self):
        return self.value.shape

    @property
    def dtype(self):
        return self.value.dtype

    def __array__(self, dtype=None, copy=None):
        arr = self.value.detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return f"ConstArray(shape={tuple(self.shape)}, dtype={self.dtype})"


class DeviceBuffer:
    """A tracked device allocation: what ``cudaMalloc`` hands back."""

    __slots__ = ("_value", "alloc_id", "space", "_state")

    def __init__(self, value: torch.Tensor, space: Space = Space.GLOBAL):
        self._value = value
        self.alloc_id = next(_ALLOC_IDS)
        self.space = space
        self._state = "live"

    @property
    def live(self) -> bool:
        return self._state == "live"

    def _require_live(self, op: str):
        if self._state != "live":
            raise CudaError(
                f"cudaErrorInvalidValue: {op} on {self._state} DeviceBuffer "
                f"#{self.alloc_id} (use-after-free)")

    def _free(self):
        if self._state != "live":
            raise CudaError(
                f"cudaErrorInvalidValue: double free of DeviceBuffer "
                f"#{self.alloc_id}")
        self._state = "freed"
        self._value = None          # release the device storage

    def _rebind(self, value):
        """Point the handle at new storage (launch output / h2d target)."""
        self._require_live("write")
        self._value = value

    @property
    def value(self) -> torch.Tensor:
        self._require_live("read")
        return self._value

    @property
    def shape(self):
        return self.value.shape

    @property
    def dtype(self):
        return self.value.dtype

    def __array__(self, dtype=None, copy=None):
        arr = self.value.detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        if self._state != "live":
            return f"DeviceBuffer(#{self.alloc_id}, {self._state})"
        return (f"DeviceBuffer(#{self.alloc_id}, shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, space={self.space.value})")


def unwrap(buf, op: str = "access"):
    """The raw tensor behind a handle (liveness-checked), or ``buf``."""
    if isinstance(buf, ConstArray):
        return buf.value
    if isinstance(buf, DeviceBuffer):
        buf._require_live(op)
        return buf._value
    return buf


def cuda_malloc(shape, dtype=torch.float32, space: Space = Space.GLOBAL,
                device=None):
    """cudaMalloc analogue: zero-filled tracked buffer in the given space."""
    if space is Space.TEXTURE:
        raise UnsupportedSpace(
            "texture memory is unsupported (paper Table II: hybridsort/"
            "kmeans/leukocyte/mummergpu fall out for every framework)")
    if space is Space.SHARED:
        raise UnsupportedSpace(
            "__shared__ memory is block-scoped: declare it in "
            "KernelDef.shared (or the dyn_shared launch slot for extern "
            "arrays); it cannot be heap-allocated")
    value = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
    if space is Space.CONST:
        return ConstArray(value)
    return DeviceBuffer(value, space=space)


def cuda_free(buf) -> None:
    """cudaFree: invalidate the handle; double/stale frees raise."""
    if not isinstance(buf, DeviceBuffer):
        raise CudaError(
            f"cudaErrorInvalidValue: cuda_free of {type(buf).__name__} "
            f"(only DeviceBuffer handles from cuda_malloc can be freed)")
    buf._free()


def _to_device(host, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host)).to(
        resolve_device(device))


def cuda_memcpy_to_symbol(host, device=None) -> ConstArray:
    """``cudaMemcpyToSymbol``: populate a ``__constant__`` buffer."""
    return ConstArray(_to_device(host, device))


def cuda_memcpy_h2d(host, dst: DeviceBuffer | None = None, device=None):
    """``cudaMemcpy`` host-to-device.

    Bare it allocates and copies, returning a fresh handle; with ``dst`` it
    copies into that allocation (geometry-checked) and returns it.
    """
    if dst is None:
        return DeviceBuffer(_to_device(host, device))
    if not isinstance(dst, DeviceBuffer):
        raise CudaError(
            f"cudaErrorInvalidValue: h2d destination must be a DeviceBuffer "
            f"handle, got {type(dst).__name__}")
    arr = torch.from_numpy(np.ascontiguousarray(host))
    _check_geometry("h2d", dst.shape, dst.dtype, arr.shape, arr.dtype)
    dst._rebind(arr.to(dst.value.device))
    return dst


def cuda_memcpy_d2h(dev) -> np.ndarray:
    """``cudaMemcpy`` device-to-host (blocks until the value is ready)."""
    return unwrap(dev, "cuda_memcpy_d2h").detach().cpu().numpy()


def _check_geometry(kind, dshape, ddtype, sshape, sdtype):
    if tuple(dshape) != tuple(sshape) or ddtype != sdtype:
        raise CudaError(
            f"cudaErrorInvalidValue: {kind} copy geometry mismatch - "
            f"destination ({tuple(dshape)}, {ddtype}) vs source "
            f"({tuple(sshape)}, {sdtype})")


def resolve_launch_args(kernel, args: dict) -> dict:
    """Enforce buffer-object semantics on a launch's bindings.

    * a :class:`ConstArray` bound to a buffer the kernel ``writes`` raises
      :class:`UnsupportedSpace`;
    * a freed :class:`DeviceBuffer` raises :class:`CudaError`;
    * everything unwraps to plain tensors for packing.
    """
    out = {}
    for name, buf in args.items():
        if isinstance(buf, ConstArray):
            if name in kernel.writes:
                raise UnsupportedSpace(
                    f"kernel {kernel.name}: buffer {name!r} is __constant__ "
                    f"(ConstArray) but is in the kernel's write set "
                    f"{tuple(kernel.writes)}; constant memory is read-only")
            out[name] = buf.value
        elif isinstance(buf, DeviceBuffer):
            if not buf.live:
                raise CudaError(
                    f"kernel {kernel.name}: buffer {name!r} bound to "
                    f"{buf._state} DeviceBuffer #{buf.alloc_id} "
                    f"(cudaErrorInvalidValue: use-after-free at launch)")
            out[name] = buf._value
        elif isinstance(buf, torch.Tensor):
            out[name] = buf
        else:
            raise TypeError(
                f"kernel {kernel.name}: buffer {name!r} is a "
                f"{type(buf).__name__}; bind torch tensors, DeviceBuffer or "
                f"ConstArray handles (carry.from_reference converts NumPy)")
    return out


def donated_names(kernel, args: dict) -> tuple[str, ...]:
    """Written buffers bound by live handle that the kernel declared in
    ``donates``: their handles re-bind to the launch's outputs."""
    return tuple(sorted(
        name for name in kernel.donates
        if isinstance(args.get(name), DeviceBuffer)))


def rebind_outputs(kernel, args: dict, out: dict) -> dict:
    """Re-bind donated handles to the launch's outputs (CUDA in-place view).

    Chained launches keep passing the same handles - the ping-pong of
    Rodinia's wavefront codes - while other bindings come back as tensors.
    """
    res = dict(out)
    for name in donated_names(kernel, args):
        handle = args[name]
        handle._rebind(res[name])
        res[name] = handle
    return res
