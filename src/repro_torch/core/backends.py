"""Pluggable backend registry for kernel lowerings.

A *backend* is a name plus a builder with the uniform lowering signature::

    builder(kernel, *, grid: Dim3, block: Dim3, glob, grain, dyn_shared,
            interpret) -> new glob dict

a ``check(kernel, block)`` that raises :class:`UnsupportedKernel` before
anything runs, and capability tags for coverage reporting (a row of the
paper's Table II):

* ``"barrier"`` - can split at ``__syncthreads`` (loop fission);
* ``"warp"``    - supports warp-level shuffles/votes;
* ``"dim3"``    - accepts multi-dimensional grids/blocks;
* ``"native"``  - launches hand-written kernels on the card.

The port registers ``loop``, ``loop_nowarp``, ``naive``, ``vector`` and
``cuda``; the reference's ``pallas``, ``shard`` and ``shard_vector`` have
no counterpart here (``cuda`` takes ``pallas``'s place).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable


class UnknownBackend(KeyError):
    """Raised when a launch names a backend that was never registered."""


def _no_check(kernel, block) -> None:
    return None


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered lowering: ``run`` has the uniform builder signature."""

    name: str
    run: Callable
    capabilities: frozenset[str] = frozenset()
    check: Callable = _no_check

    def supports(self, *caps: str) -> bool:
        return all(c in self.capabilities for c in caps)


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, builder: Callable,
                     capabilities: Iterable[str] = (), *,
                     check: Callable = _no_check,
                     overwrite: bool = False) -> Backend:
    """Register ``builder`` under ``name``; returns the ``Backend`` entry.

    Registering an existing name raises unless ``overwrite=True``.
    """
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered; pass "
                         f"overwrite=True to replace it")
    entry = Backend(name=name, run=builder,
                    capabilities=frozenset(capabilities), check=check)
    _REGISTRY[name] = entry
    return entry


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackend(
            f"unknown backend {name!r}; registered: {backend_names()}"
        ) from None


def backend_names() -> tuple[str, ...]:
    """All registered backend names, in registration order."""
    return tuple(_REGISTRY)


def _register_builtins() -> None:
    from repro_torch.core import lower_cuda, lower_loop, lower_vector

    def loop_variant(**flags):
        def run(kernel, *, grid, block, glob, grain, dyn_shared, interpret):
            return lower_loop.run(kernel, grid=grid, block=block, glob=glob,
                                  grain=grain, dyn_shared=dyn_shared, **flags)

        def check(kernel, block):
            lower_loop.check(kernel, block, **flags)
        return run, check

    def vector(kernel, *, grid, block, glob, grain, dyn_shared, interpret):
        return lower_vector.run(kernel, grid=grid, block=block, glob=glob,
                                grain=grain, dyn_shared=dyn_shared)

    for name, flags, caps in (
            ("loop", {}, {"barrier", "warp", "dim3"}),
            ("loop_nowarp", {"allow_warp": False}, {"barrier", "dim3"}),
            ("naive", {"allow_fission": False, "allow_warp": False},
             {"dim3"})):
        run, check = loop_variant(**flags)
        register_backend(name, run, caps, check=check)
    register_backend("vector", vector, {"barrier", "warp", "dim3"})
    register_backend("cuda", lower_cuda.run,
                     {"barrier", "warp", "dim3", "native"},
                     check=lower_cuda.check)


_register_builtins()
