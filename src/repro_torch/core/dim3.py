"""CUDA ``dim3`` launch geometry.

CUDA kernels are launched over a 3-D grid of 3-D blocks
(``kernel<<<dim3(gx,gy,gz), dim3(bx,by,bz)>>>``); CuPBoP preserves this
shape in its runtime-assigned variables (paper SIII-B.2: ``blockIdx``/
``threadIdx`` are materialized explicitly because the target has no such
hardware registers).  The port's lowerings iterate over *linearized*
block/thread ids - ``Dim3`` is the bridge: it normalizes whatever the user
wrote (int, 1/2/3-tuple, another ``Dim3``) and converts between linear ids
and ``(x, y, z)`` coordinates with CUDA's x-fastest ordering::

    linear = x + y * dim.x + z * dim.x * dim.y
"""
from __future__ import annotations

from typing import NamedTuple


class Dim3(NamedTuple):
    """A CUDA ``dim3``: extents along x, y, z (missing axes default to 1)."""

    x: int = 1
    y: int = 1
    z: int = 1

    @classmethod
    def of(cls, v) -> "Dim3":
        """Normalize ``int | (x,) | (x, y) | (x, y, z) | Dim3`` to ``Dim3``."""
        if isinstance(v, Dim3):
            return v
        if isinstance(v, (tuple, list)):
            if not 1 <= len(v) <= 3:
                raise ValueError(
                    f"dim3 takes 1-3 extents, got {len(v)}: {v!r}")
            ext = tuple(int(d) for d in v)
            if any(d < 1 for d in ext):
                raise ValueError(f"dim3 extents must be >= 1, got {v!r}")
            return cls(*ext)
        d = int(v)
        if d < 1:
            raise ValueError(f"dim3 extents must be >= 1, got {v!r}")
        return cls(d)

    @property
    def size(self) -> int:
        """Total element count (``gridDim.x*y*z`` / threads per block)."""
        return self.x * self.y * self.z

    def coords(self, linear):
        """Linear id -> ``(x, y, z)`` with CUDA x-fastest ordering.

        Works on python ints and integer tensors alike.
        """
        return (linear % self.x,
                (linear // self.x) % self.y,
                linear // (self.x * self.y))

    def linear(self, x, y=0, z=0):
        """``(x, y, z)`` -> linear id (inverse of :meth:`coords`)."""
        return x + y * self.x + z * (self.x * self.y)
