"""Parameter packing - the universal kernel-launch ABI (paper SIII-C.2).

CuPBoP packs every kernel argument into one ``void**`` so a single
task-queue entry type can launch any kernel; a host prologue packs and a
kernel prologue unpacks (Listing 5).  Here the buffers travel as a tuple
of tensors in sorted-name order (the ``void**``) plus the tuple of names
(the type information the prologues encode).
"""
from __future__ import annotations


def pack(args: dict) -> tuple[tuple, tuple[str, ...]]:
    """Host prologue: buffer dict -> (leaves in sorted-name order, names)."""
    names = tuple(sorted(args))
    return tuple(args[n] for n in names), names


def unpack(packed, names) -> dict:
    """Kernel prologue: (leaves, names) -> the buffer dict."""
    return dict(zip(names, packed, strict=True))
