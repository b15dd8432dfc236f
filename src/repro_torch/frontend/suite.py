"""The ``.cu`` corpus and its frontend twins of hand-written suite entries.

Each corpus file is genuine CUDA-C for a kernel the port's hand-written
suite (:mod:`repro_torch.core.cuda_suite`) also implements directly in the
IR, and a byte-identical copy of the reference package's.
:func:`frontend_twin` translates the ``.cu`` source and wraps it in a
clone of the hand-written :class:`~repro_torch.core.cuda_suite.SuiteEntry`
- same launch geometry, same inputs, same oracle, same launch chain - so
the two can be launched side by side and their output buffers compared
*bit for bit* (the ``mode="frontend"`` conformance cells, and the
``python -m repro_torch.frontend`` gate).

The frontend subset only has 1-D buffers (C pointers index flat memory),
so twins of kernels with 2-D inputs (bfs ``edges``, pathfinder ``wall``,
needle ``score``/``sim``) flatten them row-major; the ``.cu`` source
carries the ``a[i * W + j]`` indexing a CUDA author would write anyway,
and ``tobytes()`` bit comparison is layout-agnostic.  The chains' hooks
touch none of the flattened buffers (they ping-pong ``src``/``dst`` and
``nxt``/``frontier`` and step ``row``/``level``/``diag``), so they serve
the twin unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

from repro_torch.core import cuda_suite
from repro_torch.frontend.translate import TranslatedKernel, translate

CORPUS_DIR = Path(__file__).parent / "corpus"

#: corpus kernel name -> hand-written twin in cuda_suite (same name)
CORPUS: tuple[str, ...] = ("vecadd", "reverse", "stencil1d",
                           "bfs_frontier", "pathfinder", "needle_nw")

#: scalar-parameter launch values per kernel (macro names would instead
#: override the source's #define table - see translate())
BINDS: dict[str, dict] = {"vecadd": {"n": 4096}}


@functools.cache
def _bases() -> dict[str, cuda_suite.SuiteEntry]:
    return {e.name: e for e in cuda_suite.build_suite(scale=1)}


def corpus_source(name: str) -> str:
    return (CORPUS_DIR / f"{name}.cu").read_text()


def translate_corpus(name: str, overrides: dict | None = None, *,
                     base: cuda_suite.SuiteEntry | None = None
                     ) -> TranslatedKernel:
    """Translate one corpus kernel, carrying over the hand-written twin's
    launch-contract declarations (combines/donates/cost estimate - not
    expressible in CUDA source).  ``overrides`` extends/overrides the
    bind table: the gate's ``--inject`` self-test plants ``PENALTY=3``
    into needle_nw this way to prove mistranslations are caught, and a
    twin at another size binds the source's macros to it.  ``base`` is
    the hand-written entry (``build_suite(1)``'s by default)."""
    if name not in CORPUS:
        raise KeyError(f"no corpus kernel {name!r} (have: {CORPUS})")
    kernel = (base or _bases()[name]).kernel
    bind = dict(BINDS.get(name, {}))
    bind.update(overrides or {})
    return translate(corpus_source(name), bind=bind,
                     combines=dict(kernel.combines),
                     donates=kernel.donates,
                     est_block_work=kernel.est_block_work)


@functools.cache
def _translated(name: str) -> TranslatedKernel:
    return translate_corpus(name)


def frontend_twin(name: str, overrides: dict | None = None, *,
                  base: cuda_suite.SuiteEntry | None = None
                  ) -> cuda_suite.SuiteEntry:
    """A launchable SuiteEntry whose kernel comes from the ``.cu`` source.

    The clone keeps the hand-written entry's geometry, inputs, oracle,
    and launch chain, swapping in the translated kernel (and flattening
    any 2-D buffers to match the frontend's flat-pointer view).  ``base``
    is the hand-written entry to clone (``build_suite(1)``'s by default);
    at another size, ``overrides`` must bind the source's macros to it.
    """
    if base is None:
        base = _bases()[name]
        tk = (_translated(name) if overrides is None
              else translate_corpus(name, overrides))
    else:
        tk = translate_corpus(name, overrides, base=base)
    probe = base.make_args(np.random.default_rng(42))
    shapes = {k: np.asarray(v).shape for k, v in probe.items()}

    def _flat(d: dict) -> dict:
        return {k: np.asarray(v).reshape(-1)
                if np.asarray(v).ndim > 1 else v for k, v in d.items()}

    def make_args(r):
        return _flat(base.make_args(r))

    def reference(a):
        unflat = {k: np.asarray(v).reshape(shapes[k]) if k in shapes
                  else v for k, v in a.items()}
        return _flat(base.reference(unflat))

    chain = base.chain
    if chain is not None:
        chain = dataclasses.replace(chain, steps=tuple(
            dataclasses.replace(s, kernel=tk.kernel)
            for s in chain.steps))
    return dataclasses.replace(
        base, name=f"{name}@cu", kernel=tk.kernel, chain=chain,
        make_args=make_args, reference=reference)
