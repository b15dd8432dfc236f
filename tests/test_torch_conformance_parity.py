"""The cross-framework column: the port's conformance cells against the
reference's at the same points, on the CPU.

Each point is one ``(case, axis, dtype, grid, block, grain, mode)`` of the
matrix, as ``repro_torch.core.conformance`` enumerates it with every
variant on; both packages build the point's entry from their own
registries, draw its inputs from ``np.random.default_rng(42)`` and run it
through their own ``run_entry``:

* here, every host point of every case on ``vector`` (base, grain 3,
  each Dim3 refactorization, each extra dtype) against the reference's
  ``vector``, and every base point on ``cuda`` (the kernels' plain
  versions, since the tensors lie on the CPU) against the reference's
  ``pallas`` (interpret mode), whose place ``cuda`` takes.  No base point
  departs; the points where ``cuda`` refuses what the reference's
  lowerings run are the geometry and dtype points, which the reference's
  matrix never gives ``pallas`` (``tests/test_torch_conformance.py``
  names each refusal, ROADMAP "Deliberate departures");
* in ``tests/test_torch_conformance_parity_chains.py``, the chains'
  ``device_resident`` and ``graph`` points on ``vector``, and vecadd,
  scan_block and needle_nw at grains 1 and 3 on ``loop`` against the
  reference's ``loop``;
* in ``tests/test_torch_coverage_parity.py``, ``api.supported`` /
  ``api.coverage`` against the reference's;
* here too, every case's ``optimized`` point on ``vector`` (the host
  replay with the barrier-fission optimizer on) against the reference's
  ``optimized`` cell on its ``vector``, except softmax_row's and
  srad_step's: the reference's optimizer cannot analyze those two under
  this JAX (``OPTIMIZED_CAVEAT``, ROADMAP "Reference caveats"), and the
  port's runs of them are held by their own bit identity in
  ``tests/test_torch_analyze_parity.py``, ``tests/test_torch_optimize.py``
  and ``tests/test_torch_optimize_chains.py``.

The chains file shares this one's helpers; the split keeps each file
under a minute and a half of CPU time.

The statuses must agree.  Integer buffers, the entries whose order the
reference fixes (``BIT_EXACT`` of ``tests/test_torch_suite.py``) and the
chains whose values are integers in every dtype (pathfinder, needle_nw)
must agree bit for bit; every other buffer within the point's oracle
tolerance.  The reference's f64 points enter JAX's x64 mode through
``JAX_X64`` of ``tests/test_torch_x64.py`` (the reference's own
``run_cell`` calls ``jax.experimental.enable_x64``, which this JAX lacks).
"""
import numpy as np
import pytest

from repro.core import conformance as jconf
from repro.core import cuda_suite as jsuite
from repro.core.kernel import UnsupportedKernel as JUnsupportedKernel
from repro.frontend import suite as jfsuite
from repro_torch.core import conformance
from test_torch_suite import BIT_EXACT
from test_torch_x64 import JAX_X64

CASES = {c.name: c for c in conformance.build_cases()}
FRONTEND_CORPUS = conformance.FRONTEND_CORPUS
JCASES = {c.name: c for c in jconf.build_cases()}
#: chains whose buffers hold integer values in every dtype variant
INTEGER_VALUED = ("pathfinder", "needle_nw")
#: cases whose optimized cell the reference cannot run under this JAX
OPTIMIZED_CAVEAT = {
    "softmax_row": "the reference's analyzer hits __jax_array__, which "
                   "JAX 0.9 refuses during abstractification",
    "srad_step": "the reference's analyzer hits __jax_array__, which "
                 "JAX 0.9 refuses during abstractification",
}


def _points(name: str) -> list[tuple]:
    case = CASES[name]
    entries = {tag: case.make(tag) for tag in case.dtypes}
    return conformance._points(case, entries, variants=True)


VECTOR_POINTS = [(name, *p) for name in CASES for p in _points(name)
                 if p[-1] == "host"]
BASE_POINTS = [(name, *_points(name)[0]) for name in CASES]


def _id(point) -> str:
    name, axis, tag, grid, _, grain, _ = point
    shape = "x".join(map(str, np.atleast_1d(grid)))
    return f"{name}-{axis}-{tag}-{shape}-g{grain}"


def _reference(name, backend, tag, grid, block, grain, mode):
    """The reference's cell at the point: (status, NumPy buffers)."""
    jcase = JCASES[name]
    entry = jcase.make(tag)
    geo = {} if entry.chain is not None else {"grid": grid, "block": block}
    with JAX_X64(tag == "f64"):
        try:
            out, want = jsuite.run_entry(entry, backend, grain=grain,
                                         chain_mode=jconf._CHAIN_MODE[mode],
                                         optimize=True if mode == "optimized"
                                         else None, **geo)
        except JUnsupportedKernel:
            return "unsupport", None
        out = {k: np.asarray(v) for k, v in out.items()}
    _, bad = jconf._oracle_check(out, want, jconf._tol_for(entry, jcase, tag))
    return ("fail" if bad else "pass"), out


def _check(point, backend, ref_backend):
    name, _, tag, grid, block, grain, mode = point
    case = CASES[name]
    entry = case.make(tag)
    cell, out = conformance.run_cell(entry, case, backend, tag, grid, block,
                                     grain, mode, device="cpu")
    status, want = _reference(name, ref_backend, tag, grid, block, grain,
                              mode)
    assert cell.status == status, f"{cell.label()}: {cell.detail}"
    assert cell.status == "pass", cell.detail
    tol = conformance._tol_for(entry, case, tag)
    for k, v in want.items():
        got = conformance._host(out[k])
        assert got.shape == v.shape and got.dtype == v.dtype, (k, got.dtype,
                                                               v.dtype)
        if v.dtype.kind in "iub" or name in BIT_EXACT + INTEGER_VALUED:
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("point", VECTOR_POINTS, ids=_id)
def test_vector_point_agrees_with_the_reference(point):
    _check(point, "vector", "vector")


@pytest.mark.parametrize("point", BASE_POINTS, ids=_id)
def test_cuda_base_point_agrees_with_the_reference_pallas(point):
    _check(point, "cuda", "pallas")


OPTIMIZED_POINTS = [(name, *p) for name in CASES for p in _points(name)
                    if p[-1] == "optimized" and name not in OPTIMIZED_CAVEAT]


@pytest.mark.parametrize("point", OPTIMIZED_POINTS, ids=_id)
def test_optimized_point_agrees_with_the_reference(point):
    _check(point, "vector", "vector")


def test_the_points_are_the_reference_matrix_points():
    """The port sweeps the reference's geometry, dtype and grain points,
    its optimized leg (one point a case, at the base geometry, on the
    reference's backends) and its frontend leg."""
    assert jconf.OPTIMIZED_BACKENDS == conformance.OPTIMIZED_BACKENDS
    assert len(OPTIMIZED_POINTS) + len(OPTIMIZED_CAVEAT) == len(CASES)
    assert list(CASES) == list(JCASES)
    for name, case in CASES.items():
        jcase = JCASES[name]
        assert case.dtypes == jcase.dtypes and case.grains == jcase.grains
        base = jcase.make(jcase.dtypes[0])
        for _, tag, grid, block, grain, mode in _points(name):
            entry = jcase.make(tag)
            assert block == entry.block
            if mode == "host" and tag == jcase.dtypes[0] and grain == 1 \
                    and grid != base.grid:
                assert grid in jconf.grid_variants(base.grid)
            if tag != jcase.dtypes[0]:
                assert grid == entry.grid
            if mode == "optimized":
                assert (tag, grid, grain) == (jcase.dtypes[0], base.grid, 1)
        assert [p[-1] for p in _points(name)].count("optimized") == 1


@pytest.mark.parametrize("backend", conformance.FRONTEND_BACKENDS)
@pytest.mark.parametrize("name", FRONTEND_CORPUS)
def test_frontend_cell_agrees_with_the_reference(name, backend):
    """The frontend leg's cell at each corpus case: the port's status
    against the one the reference's matrix gives (its translated twin
    bit for bit the same backend's hand-written host cell), on the same
    backends, both with the inputs of ``np.random.default_rng(42)``."""
    assert jconf.FRONTEND_BACKENDS == conformance.FRONTEND_BACKENDS
    assert jconf._frontend_corpus() == FRONTEND_CORPUS
    case = CASES[name]
    entry = case.make(case.dtypes[0])
    host, out = conformance.run_cell(entry, case, backend, case.dtypes[0],
                                     entry.grid, entry.block, 1,
                                     device="cpu")
    cell = conformance.run_frontend_cell(case, backend, case.dtypes[0],
                                         entry.grid, entry.block,
                                         conformance._bits(out),
                                         device="cpu")
    jentry = JCASES[name].make(case.dtypes[0])
    try:
        theirs, _ = jsuite.run_entry(jfsuite.frontend_twin(name), backend,
                                     with_reference=False)
        base, _ = jsuite.run_entry(jentry, backend, with_reference=False)
        status = ("pass" if jconf._bits(theirs, ()) == jconf._bits(base, ())
                  else "fail")
    except JUnsupportedKernel:
        status = "unsupport"
    assert host.status == "pass"
    assert (cell.status, status) == ("pass", "pass"), cell.detail
    assert cell.mode == "frontend" and cell.anchor == f"{backend}/host"
    assert cell.bit_required and cell.bit_identical
