"""Differential cross-backend conformance harness of the port.

The counterpart of ``repro.core.conformance``: every suite workload runs
under every lowering, and they must agree.

* a :class:`ConformanceCase` registry pairs each of the 23 ``cuda_suite``
  entries with its NumPy oracle and declares its *variant axes*: other
  ``Dim3`` factorizations of the same grid (a kernel that reads only
  linearized ids must not see them), grain 3 (fetch loops with a tail),
  and extra dtypes (f32 / f64 / i32) for the dtype-polymorphic kernels;
* :func:`run_matrix` sweeps backend x geometry x dtype x grain x devices x
  replay mode.  Every cell is held against the oracle (tolerance by dtype,
  widened by the case's ``tol``); ``loop_nowarp`` and ``naive`` are the
  loop lowering restricted, so where they run a kernel they owe ``loop``'s
  bits, and the shard backends owe their inner lowering's (``shard`` ->
  ``loop``, ``shard_vector`` -> ``vector``) at every device count where
  the case is ``exact_shard``, outside ``nondeterministic_shard``.  A
  device count above the pool (:func:`repro_torch.core.lower_shard
  .pool_size`: ``CUPBOP_HOST_DEVICES`` on the CPU, the cards on CUDA) is
  a ``skip`` cell.  Chain workloads add a ``device_resident`` leg (update hooks on the
  device, the stop flag polled every k iterations) and a ``graph`` leg
  (iterations captured once and replayed), each bit for bit the same
  backend's host cell outside ``nondeterministic_shard`` and
  ``iteration_state``.  Every kernel, plain or chain, adds an
  ``optimized`` leg on ``OPTIMIZED_BACKENDS``: the host replay with the
  barrier-fission optimizer on (``optimize=True``), owing FULL bit
  identity to the same backend's host cell.  The kernels with a ``.cu``
  source in the
  frontend's corpus add a ``frontend`` leg on ``FRONTEND_BACKENDS``: the
  source translated by :mod:`repro_torch.frontend` owes FULL bit identity
  to the same backend's hand-written host cell;
* :func:`report_to_json` gives the machine-readable matrix, and the CLI
  (``python -m repro_torch.core.conformance --json out.json``) exits 1 on
  any disagreement.  ``--inject-disagreement`` registers a deliberately
  broken backend, to show that the gate trips.

Backends.  ``cuda`` stands where the reference's ``pallas`` stands.  The
grain axis sweeps ``VARIANT_BACKENDS``; the geometry and dtype axes also
take ``cuda``, whose wrappers refuse a grid that is not 1-D and a dtype
they were not written for: those points are ``unsupport`` cells carrying
the wrapper's message.  Only :class:`UnsupportedKernel` makes an
``unsupport`` cell; any other error propagates.

Device.  Every cell runs on ``device``: the card unless ``"cpu"`` is
asked for (``run_entry``'s rule).  On the CPU the graph leg runs on
``GRAPH_MODE_BACKENDS``, as in the reference; on a CUDA device it runs on
``CARD_GRAPH_MODE_BACKENDS`` instead, since a CUDA capture refuses the
``loop``/``vector`` lowerings' host-scalar copies (that refusal raises).

f64 cells run under :func:`repro_torch.x64.enable_x64`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import cuda_suite, lower_shard
from repro_torch.core.backends import (
    backend_names,
    get_backend,
    register_backend,
)
from repro_torch.core.cuda_suite import SuiteEntry, run_entry
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import UnsupportedKernel
from repro_torch.core.memory import host_array, resolve_device
from repro_torch.frontend.suite import CORPUS as FRONTEND_CORPUS
from repro_torch.frontend.suite import frontend_twin
from repro_torch.x64 import enable_x64

#: oracle tolerance floor per dtype tag (a case's own ``tol`` can widen it)
DTYPE_TOL = {"f32": 2e-5, "f64": 1e-12, "i32": 0.0}

#: which backend a backend must bit-match where it runs a kernel at all
BIT_ANCHOR = {"shard": "loop", "shard_vector": "vector",
              "loop_nowarp": "loop", "naive": "loop"}

#: backends that sweep the grain axis (the fetch loops and the shard
#: backends' block ranges live here)
VARIANT_BACKENDS = ("loop", "vector", "shard", "shard_vector")

#: backends that sweep the Dim3 geometry axis
GEOMETRY_BACKENDS = (*VARIANT_BACKENDS, "cuda")

#: backends that sweep the extra-dtype axis
DTYPE_BACKENDS = ("loop", "vector", "cuda")

#: backends that run a chain's device-resident leg
DEVICE_MODE_BACKENDS = ("loop", "vector", "cuda", "shard", "shard_vector")

#: backends that run a chain's graph leg on the CPU
GRAPH_MODE_BACKENDS = ("loop", "vector")

#: ... and on a CUDA device, where the capture is a torch.cuda.CUDAGraph
CARD_GRAPH_MODE_BACKENDS = ("cuda",)

#: backends that sweep the barrier-fission optimizer leg: every kernel
#: re-runs with ``optimize=True`` and owes FULL bit identity to the same
#: backend's unoptimized host cell - fusion is pure stage composition, so
#: any bit drift means the optimizer broke semantics (core/optimize.py).
#: ``cuda`` keeps its hand-written kernel under ``optimize`` and sweeps no
#: such cell
OPTIMIZED_BACKENDS = ("loop", "vector")

#: backends that sweep the CUDA-C frontend leg: kernels with a ``.cu``
#: corpus source (repro_torch/frontend/corpus) re-run as their
#: *translated* twin and owe FULL bit-identity to the same backend's
#: hand-written host cell - the executable form of "ingests CUDA source
#: without changing semantics".  ``cuda`` refuses a translated kernel (it
#: has no hand-written kernel), so it sweeps no such cell
FRONTEND_BACKENDS = ("loop", "vector")


@dataclasses.dataclass(frozen=True)
class ConformanceCase:
    """One suite kernel's conformance declaration.

    ``make(dtype_tag)`` builds the :class:`SuiteEntry` for that dtype; the
    first tag in ``dtypes`` is the suite's natural dtype and returns the
    shared base entry, so launch-cache warmth carries across cells.
    ``exact_shard`` declares whether the kernel's ``combines`` modes are
    exact merges (integer, max/min, owned slices, or sums of disjoint
    writes into zeroed buffers), i.e. whether the shard legs owe their
    inner lowering's bits.
    """

    name: str
    make: Callable[[str], SuiteEntry]
    dtypes: tuple[str, ...] = ("f32",)
    grains: tuple[int, ...] = (1, 3)
    exact_shard: bool = True


@dataclasses.dataclass
class Cell:
    """One matrix cell: a (kernel, backend, geometry, dtype, ...) run.

    ``mode`` is the replay axis: ``"host"`` (the per-iteration host-hop
    baseline), ``"device_resident"`` (on-device updates, k-batched stop
    polls), ``"graph"`` (captured once, replayed), ``"optimized"`` (the
    host replay with the barrier-fission optimizer on, owing full
    bit-identity to the unoptimized host cell), or ``"frontend"`` (the
    kernel's ``.cu`` corpus source translated by
    :mod:`repro_torch.frontend`, owing full bit-identity to the
    hand-written host cell).  ``devices`` is the shard count of a
    multi-device backend's cell, ``None`` for every other backend.
    """

    kernel: str
    backend: str
    grid: tuple
    block: tuple
    dtype: str
    grain: int
    devices: int | None
    status: str                       # pass | fail | unsupport | skip
    mode: str = "host"
    max_abs_err: float | None = None
    anchor: str | None = None
    bit_required: bool = False
    bit_identical: bool | None = None
    detail: str = ""

    def label(self) -> str:
        dev = "" if self.devices is None else f"@dev{self.devices}"
        mode = "" if self.mode == "host" else f" mode={self.mode}"
        return (f"{self.kernel}/{self.backend}{dev} grid={self.grid} "
                f"block={self.block} {self.dtype} grain={self.grain}"
                f"{mode}")


@dataclasses.dataclass
class Report:
    cells: list[Cell]
    n_kernels: int
    backends: tuple[str, ...]
    device: str = "cpu"
    device_count: int = 1

    @property
    def disagreements(self) -> list[Cell]:
        return [c for c in self.cells if c.status == "fail"]

    def summary(self) -> dict:
        out: dict[str, dict[str, int]] = {}
        for c in self.cells:
            row = out.setdefault(c.backend,
                                 {"pass": 0, "fail": 0, "unsupport": 0,
                                  "skip": 0})
            row[c.status] += 1
        return out

    def legs(self) -> dict[str, list[str]]:
        """The backends that ran each replay leg, in ``backends`` order."""
        return {mode: [b for b in self.backends
                       if any(c.mode == mode and c.backend == b
                              for c in self.cells)]
                for mode in ("device_resident", "graph")}


# --------------------------------------------------------------------------
# dtype helpers + variant entry builders.  Base entries come verbatim from
# build_suite(); these rebuild the dtype-polymorphic kernels at other dtypes
# with matching inputs and oracle (the reference's, in NumPy).
# --------------------------------------------------------------------------
_TORCH_DT = {"f32": torch.float32, "f64": torch.float64, "i32": torch.int32}
_NUMPY_DT = {"f32": np.float32, "f64": np.float64, "i32": np.int32}


def _dt(tag: str) -> torch.dtype:
    return _TORCH_DT[tag]


def _np_dt(tag: str):
    return _NUMPY_DT[tag]


def _fvals(r, shape, tag):
    if tag == "i32":
        return r.integers(-50, 50, shape).astype(np.int32)
    return r.standard_normal(shape).astype(_np_dt(tag))


_BASE: dict[str, SuiteEntry] | None = None


def _base(name: str) -> SuiteEntry:
    global _BASE
    if _BASE is None:
        _BASE = {e.name: e for e in cuda_suite.build_suite(scale=1)}
    return _BASE[name]


def _mk_vecadd(tag: str) -> SuiteEntry:
    n, block = 1024, 128
    k = cuda_suite.make_vecadd(n)
    return SuiteEntry(
        "vecadd", ("spmd",), k, -(-n // block), block, None,
        lambda r: {"a": _fvals(r, n, tag), "b": _fvals(r, n, tag),
                   "c": np.zeros(n, _np_dt(tag))},
        lambda a: {"c": a["a"] + a["b"]})


def _mk_reduce_shared(tag: str) -> SuiteEntry:
    n, b = 1024, 128
    k = cuda_suite.make_reduce_shared(n, b, dtype=_dt(tag))
    return SuiteEntry(
        "reduce_shared", ("barrier",), k, n // b, b, None,
        lambda r: {"x": _fvals(r, n, tag),
                   "out": np.zeros(n // b, _np_dt(tag))},
        lambda a: {"out": a["x"].reshape(-1, b).sum(1)})


def _mk_reduce_warp(tag: str) -> SuiteEntry:
    n, b = 1024, 128
    k = cuda_suite.make_reduce_warp(n, b, dtype=_dt(tag))
    return SuiteEntry(
        "reduce_warp", ("warp",), k, n // b, b, None,
        lambda r: {"x": _fvals(r, n, tag),
                   "out": np.zeros(n // b, _np_dt(tag))},
        lambda a: {"out": a["x"].reshape(-1, b).sum(1)})


def _mk_matmul(tag: str) -> SuiteEntry:
    mm = 16
    k = cuda_suite.make_matmul_tiled(mm, mm, mm, tile=8, dtype=_dt(tag))
    return SuiteEntry(
        "matmul_tiled", ("barrier", "demotion"), k, (mm // 8) ** 2, 64,
        None,
        lambda r: {"a": _fvals(r, (mm, mm), tag),
                   "b": _fvals(r, (mm, mm), tag),
                   "c": np.zeros((mm, mm), _np_dt(tag))},
        lambda a: {"c": a["a"] @ a["b"]})


def _mk_stencil1d(tag: str) -> SuiteEntry:
    n, b = 1024, 128
    k = cuda_suite.make_stencil1d(n, b, dtype=_dt(tag))
    idx = np.arange(n)
    return SuiteEntry(
        "stencil1d", ("barrier",), k, n // b, b, None,
        lambda r: {"x": _fvals(r, n, tag), "y": np.zeros(n, _np_dt(tag))},
        lambda a: {"y": (0.25 * a["x"][np.clip(idx - 1, 0, None)]
                         + 0.5 * a["x"]
                         + 0.25 * a["x"][np.clip(idx + 1, None, n - 1)])})


def _mk_softmax(tag: str) -> SuiteEntry:
    rows, b = 8, 128
    k = cuda_suite.make_softmax_row(rows, b, dtype=_dt(tag))

    def ref(a):
        e = np.exp(a["x"] - a["x"].max(1, keepdims=True))
        return {"y": e / e.sum(1, keepdims=True)}

    return SuiteEntry(
        "softmax_row", ("barrier",), k, rows, b, None,
        lambda r: {"x": _fvals(r, (rows, b), tag),
                   "y": np.zeros((rows, b), _np_dt(tag))},
        ref)


def _mk_scan(tag: str) -> SuiteEntry:
    b, n = 128, 512
    k = cuda_suite.make_scan_block(n, b, dtype=_dt(tag))
    return SuiteEntry(
        "scan_block", ("barrier", "demotion"), k, n // b, b, None,
        lambda r: {"x": _fvals(r, n, tag), "y": np.zeros(n, _np_dt(tag))},
        lambda a: {"y": np.cumsum(a["x"].reshape(-1, b), 1).reshape(-1)})


def _mk_transpose(tag: str) -> SuiteEntry:
    h = w = 32
    k = cuda_suite.make_transpose_tiled(h, w, dtype=_dt(tag))
    return SuiteEntry(
        "transpose_tiled", ("barrier",), k, (h // 8) * (w // 8), 64, None,
        lambda r: {"x": _fvals(r, (h, w), tag),
                   "y": np.zeros((w, h), _np_dt(tag))},
        lambda a: {"y": a["x"].T.copy()})


def _mk_pixel(tag: str) -> SuiteEntry:
    n, b = 1024, 128
    k = cuda_suite.make_pixel_pipeline(n, b, dtype=_dt(tag))
    return SuiteEntry(
        "pixel_pipeline", ("barrier",), k, n // b, b, None,
        lambda r: {"img": r.uniform(0.5, 2.0, n).astype(_np_dt(tag)),
                   "out": np.zeros(n, _np_dt(tag))},
        lambda a: {"out": np.exp(np.log(a["img"]) * _np_dt(tag)(0.85)
                                 + _np_dt(tag)(0.1))})


def _make_from(base_name: str, builder=None, base_tag: str = "f32"):
    def make(tag: str) -> SuiteEntry:
        if tag == base_tag or builder is None:
            return _base(base_name)
        return builder(tag)
    return make


def build_cases() -> list[ConformanceCase]:
    """The registry: every suite kernel, with its applicable variant axes."""
    return [
        ConformanceCase("vecadd", _make_from("vecadd", _mk_vecadd),
                        dtypes=("f32", "f64", "i32")),
        ConformanceCase("reverse", _make_from("reverse", base_tag="i32"),
                        dtypes=("i32",)),
        ConformanceCase("histogram", _make_from("histogram",
                                                base_tag="i32"),
                        dtypes=("i32",)),
        ConformanceCase("reduce_shared",
                        _make_from("reduce_shared", _mk_reduce_shared),
                        dtypes=("f32", "f64")),
        ConformanceCase("reduce_warp",
                        _make_from("reduce_warp", _mk_reduce_warp),
                        dtypes=("f32", "f64")),
        ConformanceCase("matmul_tiled",
                        _make_from("matmul_tiled", _mk_matmul),
                        dtypes=("f32", "f64")),
        ConformanceCase("stencil1d", _make_from("stencil1d", _mk_stencil1d),
                        dtypes=("f32", "f64")),
        ConformanceCase("stencil2d", _make_from("stencil2d")),
        ConformanceCase("softmax_row", _make_from("softmax_row",
                                                  _mk_softmax),
                        dtypes=("f32", "f64")),
        ConformanceCase("scan_block", _make_from("scan_block", _mk_scan),
                        dtypes=("f32", "f64")),
        ConformanceCase("transpose_tiled",
                        _make_from("transpose_tiled", _mk_transpose),
                        dtypes=("f32", "f64", "i32")),
        ConformanceCase("pixel_pipeline",
                        _make_from("pixel_pipeline", _mk_pixel),
                        dtypes=("f32", "f64")),
        ConformanceCase("bfs_frontier", _make_from("bfs_frontier",
                                                   base_tag="i32"),
                        dtypes=("i32",)),
        ConformanceCase(
            "pathfinder",
            _make_from("pathfinder",
                       lambda tag: cuda_suite.entry_pathfinder(
                           dtype=_dt(tag)),
                       base_tag="i32"),
            dtypes=("i32", "f32", "f64")),
        ConformanceCase(
            "needle_nw",
            _make_from("needle_nw",
                       lambda tag: cuda_suite.entry_needle_nw(
                           dtype=_dt(tag)),
                       base_tag="i32"),
            dtypes=("i32", "f32")),
        ConformanceCase("backprop_layer", _make_from("backprop_layer")),
        ConformanceCase("lud_diag", _make_from("lud_diag")),
        ConformanceCase("srad_step", _make_from("srad_step")),
        ConformanceCase("lavamd", _make_from("lavamd")),
        ConformanceCase("nn", _make_from("nn")),
        ConformanceCase("kmeans", _make_from("kmeans")),
        ConformanceCase("streamcluster",
                        _make_from("streamcluster", base_tag="i32"),
                        dtypes=("i32",)),
        ConformanceCase("hotspot", _make_from("hotspot")),
    ]


# --------------------------------------------------------------------------
# geometry variants: any Dim3 factorization of the same linear grid size is
# equivalent for kernels that read only linearized ids (x-fastest ordering
# makes linear bid identical), so 2-D/3-D launches must be bit-invariant
# --------------------------------------------------------------------------
def grid_variants(g: int) -> list[tuple]:
    out: list[tuple] = []
    for a in (2, 3, 4, 5, 7, 8):
        if g % a == 0 and g // a > 1:
            out.append((g // a, a))
            break
    for a in (2, 4):
        if g % (a * a) == 0 and g // (a * a) > 1:
            out.append((g // (a * a), a, a))
            break
    return out


def graph_mode_backends(device) -> tuple[str, ...]:
    """The backends that run the graph leg on ``device``."""
    return (CARD_GRAPH_MODE_BACKENDS
            if torch.device(device).type == "cuda" else GRAPH_MODE_BACKENDS)


def _tol_for(entry: SuiteEntry, case: ConformanceCase, tag: str) -> float:
    if tag == case.dtypes[0]:
        return max(entry.tol, DTYPE_TOL[tag])
    return DTYPE_TOL[tag] if tag != "f32" else max(entry.tol,
                                                   DTYPE_TOL["f32"])


def _host(v) -> np.ndarray:
    """A buffer's values on the host: a tensor's, or a ConstArray's."""
    return host_array(getattr(v, "value", v))


def _oracle_check(out, want, tol: float) -> tuple[float, list[str]]:
    bad, max_err = [], 0.0
    for k, v in want.items():
        got, v = _host(out[k]), np.asarray(v)
        if got.shape != v.shape:
            bad.append(f"{k}: shape {got.shape} != {v.shape}")
            max_err = float("inf")
            continue
        err = float(np.max(np.abs(got.astype(np.float64)
                                  - v.astype(np.float64)))) if v.size else 0.0
        max_err = max(max_err, err)
        if not np.allclose(got, v, rtol=tol, atol=tol):
            bad.append(f"{k}: max|err|={err:.3g}")
    return max_err, bad


def _bits(out, exclude: tuple[str, ...] = ()) -> dict[str, bytes]:
    return {k: _host(v).tobytes() for k, v in out.items()
            if k not in exclude}


#: Cell.mode -> run_entry's chain_mode ("optimized" replays the host path
#: with the barrier-fission optimizer on)
_CHAIN_MODE = {"host": "host", "device_resident": "device", "graph": "graph",
               "optimized": "host"}


def run_cell(entry: SuiteEntry, case: ConformanceCase, backend: str,
             tag: str, grid, block, grain: int, mode: str = "host", *,
             device=None, devices: int | None = None
             ) -> tuple[Cell, dict | None]:
    """Run one matrix cell on ``device`` (the card unless ``"cpu"``) at
    ``devices`` shards of a multi-device backend; returns (cell, output
    buffers, or None for an ``unsupport`` cell)."""
    cell = Cell(kernel=case.name, backend=backend,
                grid=tuple(Dim3.of(grid)), block=tuple(Dim3.of(block)),
                dtype=tag, grain=grain, devices=devices, status="pass",
                mode=mode)
    geo = {} if entry.chain is not None else {"grid": grid, "block": block}
    ctx = enable_x64() if tag == "f64" else contextlib.nullcontext()
    try:
        with ctx:
            out, want = run_entry(entry, backend, grain=grain,
                                  chain_mode=_CHAIN_MODE[mode],
                                  device=device, devices=devices,
                                  optimize=True if mode == "optimized"
                                  else None, **geo)
    except UnsupportedKernel as e:
        cell.status = "unsupport"
        cell.detail = str(e).splitlines()[0]
        return cell, None
    cell.max_abs_err, bad = _oracle_check(out, want,
                                          _tol_for(entry, case, tag))
    if bad:
        cell.status = "fail"
        cell.detail = "oracle mismatch: " + "; ".join(bad)
    return cell, out


def _points(case: ConformanceCase, entries: dict[str, SuiteEntry],
            variants: bool) -> list[tuple]:
    """The case's axis points ``(axis, tag, grid, block, grain, mode)``,
    the base point first."""
    base_tag = case.dtypes[0]
    base = entries[base_tag]
    points = [("base", base_tag, base.grid, base.block, 1, "host")]
    if not variants:
        return points
    for g in case.grains:
        if g != 1:
            points.append(("grain", base_tag, base.grid, base.block, g,
                           "host"))
    if base.chain is None and base.dim3_free and isinstance(base.grid, int):
        for gv in grid_variants(base.grid):
            points.append(("geometry", base_tag, gv, base.block, 1, "host"))
    for tag in case.dtypes[1:]:
        e = entries[tag]
        points.append(("dtype", tag, e.grid, e.block, 1, "host"))
    if base.chain is not None:
        for mode in ("device_resident", "graph"):
            points.append((mode, base_tag, base.grid, base.block, 1, mode))
    # the barrier-fission leg: every kernel (plain and chain) re-runs with
    # optimize=True and owes FULL bit identity to the same backend's
    # unoptimized host cell
    points.append(("optimized", base_tag, base.grid, base.block, 1,
                   "optimized"))
    if case.name in FRONTEND_CORPUS:
        # the frontend leg: the kernel's .cu source, translated, owes
        # FULL bit-identity to the hand-written host cell
        points.append(("frontend", base_tag, base.grid, base.block, 1,
                       "frontend"))
    return points


def run_frontend_cell(case: ConformanceCase, backend: str, tag: str, grid,
                      block, host_bits: dict | None, *,
                      device=None) -> Cell:
    """The ``frontend`` cell of a corpus case: its translated twin run on
    ``backend``, held bit for bit against ``host_bits``, the same
    backend's hand-written host cell (no anchor when that cell did not
    run).  An :class:`UnsupportedKernel` makes an ``unsupport`` cell."""
    cell = Cell(kernel=case.name, backend=backend,
                grid=tuple(Dim3.of(grid)), block=tuple(Dim3.of(block)),
                dtype=tag, grain=1, devices=None, status="pass",
                mode="frontend")
    try:
        twin = frontend_twin(case.name)
        out, _ = run_entry(twin, backend, with_reference=False,
                           device=device)
    except UnsupportedKernel as e:
        cell.status = "unsupport"
        cell.detail = str(e).splitlines()[0]
        return cell
    if host_bits is not None:
        got = _bits(out)
        cell.anchor = f"{backend}/host"
        cell.bit_required = True
        cell.bit_identical = got == host_bits
        if not cell.bit_identical:
            diff = [k for k in got if got[k] != host_bits.get(k)]
            cell.status = "fail"
            cell.detail = (f"ingested .cu bits differ from hand-written "
                           f"twin on {diff}")
    return cell


def run_matrix(cases: list[ConformanceCase] | None = None,
               backends: tuple[str, ...] | None = None,
               variants: bool = True, device=None,
               device_counts: tuple[int, ...] | None = None,
               anchors: dict | None = None) -> Report:
    """Sweep the conformance matrix on ``device`` and return the report.

    Every backend runs each case's base point; the variant points sweep
    the backends of their axis.  With ``variants=False`` only the base
    cell runs per (kernel, backend).  Multi-device backends run every
    point at each of ``device_counts`` (default ``(1,)``, or ``(1, N)``
    for a pool of N); a count above the pool is a ``skip`` cell.

    A cell is held against its ``BIT_ANCHOR`` when the anchor backend is
    in ``backends``.  ``anchors``, a dict passed to several calls, keeps
    the anchor cells' bits between them: a later call holds its cells
    against the bits an earlier call left there, whether or not the
    anchor backend is among its own ``backends``.
    """
    cases = build_cases() if cases is None else cases
    backends = tuple(backend_names()) if backends is None else tuple(backends)
    for b in backends:
        get_backend(b)                       # raise eagerly on typos
    dev = resolve_device(device)
    avail = lower_shard.pool_size(dev)
    if device_counts is None:
        device_counts = (1,) if avail == 1 else (1, avail)
    axis_backends = {"grain": VARIANT_BACKENDS,
                     "geometry": GEOMETRY_BACKENDS,
                     "dtype": DTYPE_BACKENDS,
                     "device_resident": DEVICE_MODE_BACKENDS,
                     "graph": graph_mode_backends(dev),
                     "optimized": OPTIMIZED_BACKENDS,
                     "frontend": FRONTEND_BACKENDS}

    anchors = {} if anchors is None else anchors
    cells: list[Cell] = []
    for case in cases:
        entries = {tag: case.make(tag) for tag in case.dtypes}
        points = _points(case, entries, variants)
        host_bits: dict[tuple, dict[str, bytes]] = {}

        def anchor_key(anchor_backend, tag, grid, block, grain):
            return (case.name, anchor_backend, tag, repr(grid), repr(block),
                    grain)

        def anchor_bits(anchor_backend, tag, grid, block, grain):
            key = anchor_key(anchor_backend, tag, grid, block, grain)
            if key not in anchors:
                e = entries[tag]
                geo = ({} if e.chain is not None
                       else {"grid": grid, "block": block})
                ctx = (enable_x64() if tag == "f64"
                       else contextlib.nullcontext())
                with ctx:
                    out, _ = run_entry(e, anchor_backend, grain=grain,
                                       with_reference=False, device=dev,
                                       **geo)
                anchors[key] = _bits(out, e.nondeterministic_shard)
            return anchors[key]

        for backend in backends:
            multi = get_backend(backend).supports("multi_device")
            devs = device_counts if multi else (None,)
            for (axis, tag, grid, block, grain, mode), d in (
                    (p, d) for p in points for d in devs):
                if axis != "base" and backend not in axis_backends[axis]:
                    continue
                if d is not None and d > avail:
                    cells.append(Cell(
                        kernel=case.name, backend=backend,
                        grid=tuple(Dim3.of(grid)),
                        block=tuple(Dim3.of(block)), dtype=tag,
                        grain=grain, devices=d, status="skip", mode=mode,
                        detail=f"only {avail} device(s) available"))
                    continue
                if mode == "frontend":
                    cells.append(run_frontend_cell(
                        case, backend, tag, grid, block,
                        host_bits.get((backend, d)), device=dev))
                    continue
                entry = entries[tag]
                cell, out = run_cell(entry, case, backend, tag, grid, block,
                                     grain, mode, device=dev, devices=d)
                cells.append(cell)
                if out is None:
                    continue
                if axis == "base":
                    host_bits[(backend, d)] = _bits(out)
                if mode != "host":
                    # the replay legs owe the SAME backend's host-hop bits;
                    # stop-poll-cadence scratch (iteration_state) is
                    # excluded, oracle outputs never; the optimized leg
                    # runs the host-hop cadence, so it owes every bit
                    base_bits = host_bits.get((backend, d))
                    if base_bits is None:
                        continue
                    skip = (() if mode == "optimized" else
                            tuple(entry.nondeterministic_shard)
                            + tuple(entry.iteration_state))
                    got = _bits(out, skip)
                    ref = {k: v for k, v in base_bits.items()
                           if k not in skip}
                    cell.anchor = f"{backend}/host"
                    cell.bit_required = True
                    cell.bit_identical = got == ref
                    if not cell.bit_identical:
                        diff = [k for k in got if got[k] != ref.get(k)]
                        cell.status = "fail"
                        cell.detail = ((cell.detail + " " if cell.detail
                                        else "")
                                       + f"{mode} replay bits differ from "
                                         f"host-hop on {diff}")
                    continue
                if backend in BIT_ANCHOR.values():
                    # this cell IS someone's anchor: seed the cache so
                    # anchor_bits never re-runs it
                    anchors.setdefault(
                        anchor_key(backend, tag, grid, block, grain),
                        _bits(out, entry.nondeterministic_shard))
                anchor = BIT_ANCHOR.get(backend)
                if anchor is None or (
                        anchor not in backends and anchor_key(
                            anchor, tag, grid, block, grain) not in anchors):
                    continue
                want = anchor_bits(anchor, tag, grid, block, grain)
                got = _bits(out, entry.nondeterministic_shard)
                cell.anchor = anchor
                cell.bit_required = (not multi) or case.exact_shard
                cell.bit_identical = got == want
                if cell.bit_required and not cell.bit_identical:
                    diff = [k for k in got if got[k] != want.get(k)]
                    cell.status = "fail"
                    cell.detail = ((cell.detail + " " if cell.detail
                                    else "")
                                   + f"bits differ from {anchor} on {diff}")
    return Report(cells=cells, n_kernels=len(cases), backends=backends,
                  device=str(dev), device_count=avail)


def report_to_json(report: Report) -> dict:
    def cell_dict(c: Cell) -> dict:
        d = dataclasses.asdict(c)
        # shape mismatches record inf, which json.dump would emit as the
        # non-RFC-8259 token Infinity; the detail string keeps the story
        if d["max_abs_err"] is not None and not math.isfinite(
                d["max_abs_err"]):
            d["max_abs_err"] = None
        return d

    _base("vecadd")                 # ensure the shared suite cache is built
    return {
        "meta": {
            "n_kernels": report.n_kernels,
            "backends": list(report.backends),
            "device": report.device,
            "torch": torch.__version__,
            "n_cells": len(report.cells),
            "legs": report.legs(),
            "device_count": report.device_count,
        },
        "kernels": {n: {"rodinia": e.rodinia,
                        "features": list(e.features)}
                    for n, e in _BASE.items()},
        "summary": report.summary(),
        "cells": [cell_dict(c) for c in report.cells],
        "disagreements": [c.label() + (f" :: {c.detail}" if c.detail else "")
                          for c in report.disagreements],
    }


def _register_broken_backend() -> None:
    """A loop clone that perturbs its first written buffer (the gate's
    self-test: a conformance gate that cannot fail gates nothing)."""
    from repro_torch.core import lower_loop

    def broken(kernel, *, grid, block, glob, grain, dyn_shared, interpret):
        out = dict(lower_loop.run(kernel, grid=grid, block=block, glob=glob,
                                  grain=grain, dyn_shared=dyn_shared))
        name = tuple(kernel.writes)[0]
        out[name] = out[name] + 1
        return out

    register_backend("broken", broken, {"barrier", "warp", "dim3"},
                     check=lower_loop.check, overwrite=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable matrix report here")
    ap.add_argument("--backends", nargs="*", default=None)
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="restrict to these suite kernels")
    ap.add_argument("--no-variants", action="store_true",
                    help="base cells only (smoke mode)")
    ap.add_argument("--inject-disagreement", action="store_true",
                    help="register a deliberately broken backend "
                         "(gate self-test)")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--devices", nargs="*", type=int, default=None,
                    help="device counts for multi-device backends "
                         "(default 1 and the whole pool)")
    args = ap.parse_args(argv)

    cases = build_cases()
    if args.kernels:
        known = {c.name for c in cases}
        bad = set(args.kernels) - known
        if bad:
            raise SystemExit(f"unknown kernel(s) {sorted(bad)}; "
                             f"have {sorted(known)}")
        cases = [c for c in cases if c.name in args.kernels]
    backends = tuple(args.backends) if args.backends else None
    if args.inject_disagreement:
        _register_broken_backend()
        if backends is None:
            backends = tuple(backend_names())

    t0 = time.perf_counter()
    report = run_matrix(cases=cases, backends=backends,
                        variants=not args.no_variants, device=args.device,
                        device_counts=(tuple(args.devices) if args.devices
                                       else None))
    seconds = time.perf_counter() - t0

    summary = report.summary()
    for b in report.backends:
        row = summary.get(b, {})
        print(f"{b:>14}: pass={row.get('pass', 0):<4} "
              f"fail={row.get('fail', 0):<3} "
              f"unsupport={row.get('unsupport', 0):<3} "
              f"skip={row.get('skip', 0)}")
    print("legs: " + " ".join(f"{m}={','.join(bs) or '-'}"
                              for m, bs in report.legs().items())
          + f" device={report.device} pool={report.device_count}"
          + f" seconds={seconds:.1f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report_to_json(report), f, indent=2)
            f.write("\n")
        print(f"matrix report written: {args.json} "
              f"({len(report.cells)} cells)")
    if report.disagreements:
        print(f"conformance gate: FAILED "
              f"({len(report.disagreements)} disagreement(s))",
              file=sys.stderr)
        for c in report.disagreements[:20]:
            print(f"  {c.label()} :: {c.detail}", file=sys.stderr)
        return 1
    print(f"conformance gate: passed ({len(report.cells)} cells, "
          f"{report.n_kernels} kernels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
