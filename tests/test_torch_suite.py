"""The port's four Rodinia chains against the JAX package, on the CPU.

Inputs come from ``np.random.default_rng(42)`` and go to both packages.
The port's ``run_entry`` under ``vector``, ``loop`` and ``cuda`` (the
kernels' plain versions, since the tensors lie on the CPU) must match the
reference's ``loop`` and ``pallas`` (interpret mode) runs: bit for bit for
bfs, pathfinder and nw, whose arithmetic is integer, and within 1e-4 for
hotspot, the entry's own tolerance (``SuiteEntry.tol``) - XLA and PyTorch
may contract or order the float32 thermal update differently.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import cuda_suite as jsuite
from repro_torch import carry
from repro_torch.core import _native, cuda_suite, lower_cuda
from repro_torch.core.api import compiled, launch
from repro_torch.core.kernel import KernelDef, UnsupportedKernel

NAMES = ("bfs_frontier", "pathfinder", "needle_nw", "hotspot")
HOTSPOT_TOL = 1e-4          # entry_hotspot's tol (cuda_suite.py:1878)


def _entries(name, **kw):
    return (getattr(jsuite, f"entry_{name}")(**kw),
            getattr(cuda_suite, f"entry_{name}")(**kw))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_match(name, got, want, keys):
    for k in keys:
        g, w = _np(got[k]), _np(want[k])
        assert g.shape == w.shape, (name, k)
        if name == "hotspot":
            np.testing.assert_allclose(g, w, rtol=HOTSPOT_TOL,
                                       atol=HOTSPOT_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@functools.cache
def _jax_run(name, backend):
    jentry, _ = _entries(name)
    out, want = jsuite.run_entry(jentry, backend)
    return {k: np.asarray(v) for k, v in out.items()}, want


@functools.cache
def _port_run(name, backend):
    _, tentry = _entries(name)
    out, want = cuda_suite.run_entry(tentry, backend, device="cpu")
    return {k: _np(v) for k, v in out.items()}, want


@pytest.mark.parametrize("name", NAMES)
def test_make_args_bit_equal(name):
    jentry, tentry = _entries(name)
    a = jentry.make_args(np.random.default_rng(42))
    b = tentry.make_args(np.random.default_rng(42))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("bfs_frontier", {}), ("bfs_frontier", {"n": 512, "deg": 6}),
    ("pathfinder", {}), ("pathfinder", {"scale": 3}),
    ("needle_nw", {}), ("needle_nw", {"n": 48, "penalty": 10}),
    ("hotspot", {}), ("hotspot", {"h": 16, "w": 24, "iters": 7})])
def test_vectorised_oracles_equal_reference_loops(name, kw):
    jentry, tentry = _entries(name, **kw)
    args = jentry.make_args(np.random.default_rng(42))
    want, got = jentry.reference(args), tentry.reference(args)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("ref", ("loop", "pallas"))
@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
@pytest.mark.parametrize("name", NAMES)
def test_run_entry_matches_reference(name, backend, ref):
    jout, want = _jax_run(name, ref)
    out, twant = _port_run(name, backend)
    _assert_match(name, out, jout, jout.keys())
    # and the oracle, within the entry's tolerance
    tol = _entries(name)[1].tol
    for k, v in want.items():
        np.testing.assert_allclose(out[k], v, rtol=tol, atol=tol, err_msg=k)
        np.testing.assert_array_equal(twant[k], v, err_msg=k)


def _launch_state(name):
    """``(jax entry, port entry, args)`` for one launch with real work:
    BFS at its widest level on a graph where claims collide, nw on its
    longest diagonal, the others at their chain's first launch."""
    if name == "bfs_frontier":
        n = 512
        jentry, tentry = _entries(name, n=n, deg=6)
        args = jentry.make_args(np.random.default_rng(42))
        dist = cuda_suite.bfs_levels(args["edges"], n)
        level = int(np.bincount(dist[dist >= 0]).argmax())
        args.update(
            frontier=(dist == level).astype(np.int32),
            visited=((dist >= 0) & (dist <= level)).astype(np.int32),
            dist=np.where(dist <= level, dist, -1).astype(np.int32),
            active=np.full(1, 3, np.int32),
            level=np.full(1, level, np.int32))
        return jentry, tentry, args
    jentry, tentry = _entries(name)
    args = jentry.make_args(np.random.default_rng(42))
    if name == "needle_nw":
        args["diag"] = np.full(1, 33, np.int32)
    return jentry, tentry, args


@pytest.mark.parametrize("name", NAMES)
def test_plain_version_matches_one_reference_launch(name):
    _check_plain_launch(name)


def _check_plain_launch(name):
    jentry, tentry, args = _launch_state(name)
    step = jentry.chain.steps[0]
    jbufs = {k: jnp.asarray(v) for k, v in args.items()}
    want = japi.launch(step.kernel, grid=step.grid, block=step.block,
                       args=jbufs, backend="loop")
    tstep = tentry.chain.steps[0]
    kern = lower_cuda.KERNELS[name]
    bufs = carry.from_reference(args, device="cpu")
    before = kern.launches
    got = kern(bufs, grid=tstep.grid, block=tstep.block,
               **dict(tstep.kernel.native.params))
    assert kern.launches == before        # the plain version is no launch
    _assert_match(name, got, want, kern.writes)
    for k, v in args.items():              # functional: inputs untouched
        np.testing.assert_array_equal(_np(bufs[k]), v)


def test_bfs_launch_settles_contested_claims_like_the_reference():
    # several frontier threads reach the same unvisited nodes, so both
    # which thread wins and how many threads win anything are fixed by the
    # reference's claim order; the plain version must reproduce both
    _, _, args = _launch_state("bfs_frontier")
    n, deg, bs = 512, 6, 32
    t = np.arange(n)[:, None]
    key = ((t // bs) * deg + np.arange(deg)[None, :]) * bs + t % bs
    nbr = args["edges"]
    claim = ((args["frontier"] == 1)[:, None] & (nbr < n)
             & (args["visited"][np.minimum(nbr, n - 1)] == 0))

    def winners(order):
        # threads that win something when the claimant with the least
        # order value takes each node
        best = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(best, nbr[claim], order[claim])
        won = claim & (best[np.minimum(nbr, n - 1)] == order)
        return int(won.any(axis=1).sum())

    # the reference's order and the reverse one count different winners,
    # so this state tells a right claim order from a wrong one
    assert winners(key) != winners(-key)
    _check_plain_launch("bfs_frontier")


@pytest.mark.parametrize("name", NAMES)
def test_chevron_launch_on_cuda_backend(name):
    _, tentry, args = _launch_state(name)
    step = tentry.chain.steps[0]
    bufs = carry.from_reference(args, const=tentry.const, device="cpu")
    got = step.kernel[step.grid, step.block].on(backend="cuda")(**bufs)
    want = step.kernel[step.grid, step.block].on(backend="vector")(bufs)
    _assert_match(name, got, want, step.kernel.writes)


@pytest.mark.parametrize("backend", ("loop", "loop_nowarp", "naive",
                                     "vector", "cuda"))
@pytest.mark.parametrize("name", NAMES)
def test_coverage_cells_match_reference(name, backend):
    # a Table-II cell: the backend expresses the kernel, or raises
    # UnsupportedKernel before it runs, exactly when the reference's
    # does (the port's cuda stands where the reference's pallas does)
    from repro.core.kernel import UnsupportedKernel as JUnsupported

    jentry, tentry, args = _launch_state(name)
    jstep, tstep = jentry.chain.steps[0], tentry.chain.steps[0]
    try:
        japi.compiled(jstep.kernel, grid=jstep.grid, block=jstep.block,
                      args={k: jnp.asarray(v) for k, v in args.items()},
                      backend="pallas" if backend == "cuda" else backend)
        jok = True
    except JUnsupported:
        jok = False
    try:
        compiled(tstep.kernel, grid=tstep.grid, block=tstep.block,
                 args=carry.from_reference(args, device="cpu"),
                 backend=backend)
        tok = True
    except UnsupportedKernel:
        tok = False
    assert tok == jok


def test_kernel_without_native_body_is_unsupported_on_cuda():
    def stage(ctx, st):
        return st

    k = KernelDef("no_body", (stage,), writes=("x",))
    with pytest.raises(UnsupportedKernel, match="no hand-written CUDA body"):
        launch(k, grid=1, block=32, args={"x": torch.zeros(32)},
               backend="cuda")
    # the same kernel runs under the lowerings that execute stages
    launch(k, grid=1, block=32, args={"x": torch.zeros(32)},
           backend="vector")


@pytest.mark.parametrize("make", [
    lambda: cuda_suite.make_pathfinder(256, 32),
    lambda: cuda_suite.make_pathfinder(256, 64, dtype=torch.float32),
    lambda: cuda_suite.make_hotspot(32, 64, tile_y=4, tile_x=4)])
def test_variants_without_a_kernel_are_unsupported_on_cuda(make):
    k = make()
    assert k.native is None
    with pytest.raises(UnsupportedKernel):
        lower_cuda.check(k, 64)


def test_wrapper_rejects_wrong_geometry_and_dtype():
    kern = lower_cuda.KERNELS["pathfinder"]
    _, tentry, args = _launch_state("pathfinder")
    bufs = carry.from_reference(args, device="cpu")
    with pytest.raises(UnsupportedKernel):
        kern(bufs, grid=8, block=32, cols=256)
    with pytest.raises(UnsupportedKernel):
        kern({**bufs, "src": bufs["src"].float()}, grid=4, block=64,
             cols=256)
    with pytest.raises(ValueError, match="shape"):
        kern(bufs, grid=4, block=64, cols=128)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    _, tentry = _entries("pathfinder")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_suite.run_entry(tentry, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carry.from_reference({"x": np.zeros(3, np.float32)})


def test_tensors_off_the_cpu_never_reach_the_plain_version(monkeypatch):
    kern = lower_cuda.KERNELS["needle_nw"]
    _, tentry, args = _launch_state("needle_nw")
    bufs = {k: torch.from_numpy(v).to("meta") for k, v in args.items()}

    def plain(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(kern, "plain", plain)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        kern(bufs, grid=2, block=16, n=32, penalty=2)
    mixed = {**carry.from_reference(args, device="cpu"),
             "sim": bufs["sim"]}
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        kern(mixed, grid=2, block=16, n=32, penalty=2)


def test_cpu_runs_build_and_launch_nothing(monkeypatch):
    def refuse():
        raise AssertionError("the kernels' library was loaded on the CPU")

    monkeypatch.setattr(_native, "library", refuse)
    before = {n: k.launches for n, k in lower_cuda.KERNELS.items()}
    stats = {}
    for name in NAMES:
        _, tentry = _entries(name)
        stats[name] = cuda_suite.ChainStats()
        cuda_suite.run_entry(tentry, "cuda", device="cpu",
                             chain_stats=stats[name])
        assert stats[name].launches > 0
    assert {n: k.launches for n, k in lower_cuda.KERNELS.items()} == before
