"""The port's suite entries against the JAX package, on the CPU: all 23,
the eleven Rodinia entries and twelve textbook ones (vecadd, reverse,
histogram, reduce_shared, reduce_warp, matmul_tiled, stencil1d,
stencil2d, softmax_row, scan_block, transpose_tiled, pixel_pipeline).

Both packages' entries come from their ``build_suite(1)``, whose
registries must agree field by field.  Inputs come from
``np.random.default_rng(42)`` and go to both packages.  The port's
``run_entry`` under ``vector``, ``loop`` and ``cuda`` (the kernels' plain
versions, since the tensors lie on the CPU) must match the reference's
``loop`` and ``pallas`` (interpret mode) runs: bit for bit for every
integer buffer, for all of kmeans's buffers (its float sums are of
integer values, exact in any order) and for the float32 entries whose
order the reference fixes (vecadd, the two reductions, the two stencils,
scan_block, transpose_tiled), and within the entry's own tolerance
(``SuiteEntry.tol``) for the other float32 buffers (hotspot, srad, nn's
distances, backprop, lud, lavamd, matmul_tiled, softmax_row,
pixel_pipeline) - XLA and PyTorch may contract or order float32 sums and
updates differently, and compute ``exp`` and ``log`` differently.
srad_step, nn and kmeans run two different kernels per iteration; the
per-launch tests take every kernel of every entry.
"""
import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core import cuda_suite as jsuite  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import _native, cuda_suite, lower_cuda  # noqa: E402
from repro_torch.core.api import compiled, launch  # noqa: E402
from repro_torch.core.dim3 import Dim3  # noqa: E402
from repro_torch.core.kernel import KernelDef, UnsupportedKernel  # noqa: E402

CHAINS = ("bfs_frontier", "pathfinder", "needle_nw", "hotspot",
          "srad_step", "nn", "kmeans")
SINGLE = ("backprop_layer", "lud_diag", "lavamd", "streamcluster")
#: single launches that the reference's build_suite defines inline
TEXTBOOK = ("vecadd", "reverse", "histogram", "reduce_shared",
            "reduce_warp", "matmul_tiled", "stencil1d", "stencil2d",
            "softmax_row", "scan_block", "transpose_tiled", "pixel_pipeline")
NAMES = CHAINS + SINGLE + TEXTBOOK
#: float buffers held bit for bit against the reference's launches:
#: kmeans's sums are of integer-valued floats, and its centroids one IEEE
#: division of them; vecadd is one add; the reductions' trees and
#: butterflies, the stencils' sums and the scan's levels fix their order;
#: a transpose is a copy
BIT_EXACT = ("kmeans", "kmeans_assign", "kmeans_update", "vecadd",
             "reduce_shared", "reduce_warp", "stencil1d", "stencil2d",
             "scan_block", "transpose_tiled")
#: ... and against the NumPy oracle (whose sums take another order)
ORACLE_EXACT = ("kmeans", "vecadd", "stencil1d", "stencil2d",
                "transpose_tiled")
#: the fields of a SuiteEntry that its registry fixes
ENTRY_FIELDS = ("name", "grid", "block", "dyn_shared", "features", "const",
                "tol", "rodinia", "dim3_free", "nondeterministic_shard",
                "iteration_state")


@functools.cache
def _suites():
    """``build_suite(1)`` of the reference and of the port, by name."""
    return ({e.name: e for e in jsuite.build_suite(1)},
            {e.name: e for e in cuda_suite.build_suite(1)})


def _entries(name, **kw):
    """The reference's and the port's entry: ``build_suite(1)``'s, or
    both packages' ``entry_<name>(**kw)`` at other sizes."""
    if not kw:
        jsuite_1, tsuite_1 = _suites()
        return jsuite_1[name], tsuite_1[name]
    return (getattr(jsuite, f"entry_{name}")(**kw),
            getattr(cuda_suite, f"entry_{name}")(**kw))


def _kernel_steps() -> dict:
    """Each kernel's ``(entry, step index)``: one step for the single
    launches and bfs, pathfinder, nw, hotspot; two for srad, nn, kmeans."""
    return {step.kernel.name: (name, i) for name in NAMES
            for i, step in enumerate(cuda_suite.entry_steps(
                _entries(name)[1]))}


STEPS = _kernel_steps()
KERNEL_NAMES = tuple(STEPS)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@functools.cache
def _tol(name):
    return _entries(name)[1].tol


def _assert_match(name, got, want, keys, exact=BIT_EXACT):
    """Integer buffers bit for bit, float32 ones within the entry's tol
    (bit for bit too for the entries and kernels in ``exact``)."""
    for k in keys:
        g, w = _np(got[k]), _np(want[k])
        assert g.shape == w.shape, (name, k)
        if g.dtype.kind == "f" and name not in exact:
            tol = _tol(STEPS[name][0] if name in STEPS else name)
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _jax_steps(jentry):
    """The reference entry's launches of one iteration."""
    if jentry.chain is None:
        return [jsuite.ChainStep(jentry.kernel, jentry.grid, jentry.block,
                                 jentry.dyn_shared)]
    return list(jentry.chain.steps)


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


@pytest.mark.parametrize("scale", (1, 2))
def test_build_suite_equals_the_reference_registry(scale):
    jentries = jsuite.build_suite(scale)
    tentries = cuda_suite.build_suite(scale)
    assert [e.name for e in tentries] == [e.name for e in jentries]
    assert sorted(e.name for e in tentries) == sorted(NAMES)
    for j, t in zip(jentries, tentries, strict=True):
        for field in ENTRY_FIELDS:
            assert getattr(t, field) == getattr(j, field), (j.name, field)
        assert (t.chain is None) == (j.chain is None), j.name
        assert [s.kernel.name for s in cuda_suite.entry_steps(t)] == \
            [s.kernel.name for s in _jax_steps(j)], j.name


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
    ("hotspot", {}), ("hotspot", {"h": 16, "w": 24, "iters": 7}),
    ("srad_step", {}), ("srad_step", {"scale": 2, "iters": 3, "lam": 0.5}),
    ("nn", {}), ("nn", {"n": 512, "block": 32, "knn": 5}),
    ("kmeans", {}), ("kmeans", {"n": 512, "k": 3, "repeat": 5}),
    ("backprop_layer", {}), ("backprop_layer", {"in_n": 256, "out_n": 4}),
    ("lud_diag", {}), ("lud_diag", {"ntiles": 3, "b": 5}),
    ("lavamd", {}), ("lavamd", {"nboxes": 5, "ppb": 7, "nnei": 4}),
    ("streamcluster", {}), ("streamcluster", {"n": 512, "k": 20}),
    *((name, {}) for name in TEXTBOOK)])
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
    # and the oracle, within the entry's tolerance (exact where the
    # reference's results are)
    _assert_match(name, out, want, want.keys(), exact=ORACLE_EXACT)
    for k, v in want.items():
        np.testing.assert_array_equal(twant[k], v, err_msg=k)


def _launch_state(name):
    """``(jax entry, port entry, args)`` for one launch with real work:
    BFS at its widest level on a graph where claims collide, nw on its
    longest diagonal, the other chains at their first launch, and the
    single-launch entries at their one launch."""
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


def _step_state(kname):
    """``(jax step, port step, args)`` for one launch of kernel ``kname``:
    the entry's launch state, advanced through the reference's launches
    of the steps before it in the chain's first iteration (a later step
    takes its own ``prepare`` hook first)."""
    name, j = STEPS[kname]
    jentry, tentry, args = _launch_state(name)
    jsteps, tsteps = _jax_steps(jentry), cuda_suite.entry_steps(tentry)
    jbufs = {k: jnp.asarray(v) for k, v in args.items()}
    for i, step in enumerate(jsteps[:j + 1]):
        if i and step.prepare is not None:
            jbufs = {**jbufs, **step.prepare(0, jbufs)}
        if i < j:
            jbufs = {**jbufs, **japi.launch(step.kernel, grid=step.grid,
                                            block=step.block, args=jbufs,
                                            backend="loop")}
    args = {k: np.asarray(v) for k, v in jbufs.items()}
    assert tsteps[j].kernel.name == kname
    return jsteps[j], tsteps[j], args


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_plain_version_matches_one_reference_launch(name):
    _check_plain_launch(name)


def _check_plain_launch(name):
    jstep, tstep, args = _step_state(name)
    grid, block = jstep.grid, jstep.block
    jbufs = {k: jnp.asarray(v) for k, v in args.items()}
    want = japi.launch(jstep.kernel, grid=grid, block=block, args=jbufs,
                       dyn_shared=jstep.dyn_shared, backend="loop")
    tkernel, tgrid, tblock = tstep.kernel, tstep.grid, tstep.block
    kern = lower_cuda.KERNELS[name]
    bufs = carry.from_reference(args, device="cpu")
    before = kern.launches
    got = kern(bufs, grid=tgrid, block=tblock,
               **lower_cuda.launch_params(tkernel, tstep.dyn_shared))
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


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_chevron_launch_on_cuda_backend(name):
    _, tstep, args = _step_state(name)
    kernel, config = tstep.kernel, (tstep.grid, tstep.block)
    if tstep.dyn_shared is not None:
        config += (tstep.dyn_shared,)
    tentry = _entries(STEPS[name][0])[1]
    bufs = carry.from_reference(args, const=tentry.const, device="cpu")
    got = kernel[config].on(backend="cuda")(**bufs)
    want = kernel[config].on(backend="vector")(bufs)
    _assert_match(name, got, want, kernel.writes)


@pytest.mark.parametrize("backend", ("loop", "loop_nowarp", "naive",
                                     "vector", "cuda"))
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_coverage_cells_match_reference(name, backend):
    # a Table-II cell: the backend expresses the kernel, or raises
    # UnsupportedKernel before it runs, exactly when the reference's
    # does (the port's cuda stands where the reference's pallas does)
    from repro.core.kernel import UnsupportedKernel as JUnsupported

    jstep, tstep, args = _step_state(name)
    jkernel, grid, block = jstep.kernel, jstep.grid, jstep.block
    tkernel, tgrid, tblock = tstep.kernel, tstep.grid, tstep.block
    try:
        japi.compiled(jkernel, grid=grid, block=block,
                      args={k: jnp.asarray(v) for k, v in args.items()},
                      dyn_shared=jstep.dyn_shared,
                      backend="pallas" if backend == "cuda" else backend)
        jok = True
    except JUnsupported:
        jok = False
    try:
        compiled(tkernel, grid=tgrid, block=tblock,
                 args=carry.from_reference(args, device="cpu"),
                 dyn_shared=tstep.dyn_shared, backend=backend)
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
    lambda: cuda_suite.make_hotspot(32, 64, tile_y=4, tile_x=4),
    lambda: cuda_suite.make_srad_update(32, 64, tile_y=4, tile_x=4),
    lambda: cuda_suite.make_matmul_tiled(32, 32, 32, tile=4)])
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
        # a chain counts its launches; a single launch replays no chain
        assert (stats[name].launches > 0) == (name in CHAINS)
    assert {n: k.launches for n, k in lower_cuda.KERNELS.items()} == before


@pytest.mark.parametrize("backend", ("vector", "cuda"))
@pytest.mark.parametrize("name,grid,block", [
    ("lud_diag", 3, None), ("streamcluster", 2, None),
    ("streamcluster", 8, 32), ("lavamd", 5, None), ("vecadd", 5, None),
    ("vecadd", 20, 64), ("histogram", 3, None), ("histogram", 8, 64),
    ("stencil1d", 5, None), ("stencil2d", (4, 2), None),
    ("softmax_row", 7, None), ("scan_block", 3, None),
    ("transpose_tiled", 10, None), ("pixel_pipeline", 9, None)])
def test_run_entry_single_launch_honours_geometry_overrides(name, grid,
                                                           block, backend):
    # the override reaches the launch: only the blocks it names run, as
    # in the reference's run_entry with the same override
    jentry, tentry = _entries(name)
    jout, _ = jsuite.run_entry(jentry, "loop", grid=grid, block=block)
    out, _ = cuda_suite.run_entry(tentry, backend, grid=grid, block=block,
                                  device="cpu")
    full, _ = cuda_suite.run_entry(tentry, backend, device="cpu")
    _assert_match(name, out, jout, tentry.kernel.writes)
    if block is None:          # fewer blocks: some outputs stay unwritten
        assert any(not np.array_equal(_np(out[k]), _np(full[k]))
                   for k in tentry.kernel.writes)


def test_run_entry_rejects_modes_and_overrides_it_cannot_apply():
    _, plain = _entries("lud_diag")
    _, chain = _entries("pathfinder")
    with pytest.raises(ValueError, match="single launch"):
        cuda_suite.run_entry(plain, "vector", chain_mode="device",
                             device="cpu")
    with pytest.raises(ValueError, match="per-step"):
        cuda_suite.run_entry(chain, "vector", grid=2, device="cpu")
    with pytest.raises(ValueError, match="per-step"):
        cuda_suite.run_entry(chain, "vector", block=32, device="cpu")
    with pytest.raises(ValueError, match="unknown chain_mode"):
        cuda_suite.run_entry(chain, "vector", chain_mode="fused",
                             device="cpu")


def test_backprop_plain_version_covers_a_block_wider_than_cuda_allows():
    # 2048 inputs: the kernel folds two inputs per thread in registers
    # before its shared tree; the plain version keeps the same tree order
    jentry, tentry = _entries("backprop_layer", in_n=2048, out_n=4)
    args = jentry.make_args(np.random.default_rng(42))
    want = japi.launch(jentry.kernel, grid=jentry.grid, block=jentry.block,
                       args={k: jnp.asarray(v) for k, v in args.items()},
                       backend="loop")
    assert tentry.block == 2048 > lower_cuda.BACKPROP_THREADS
    kern = lower_cuda.KERNELS["backprop_layer"]
    got = kern(carry.from_reference(args, device="cpu"), grid=tentry.grid,
               block=tentry.block, **dict(tentry.kernel.native.params))
    _assert_match("backprop_layer", got, want, kern.writes)
    np.testing.assert_allclose(_np(got["hidden"]),
                               tentry.reference(args)["hidden"],
                               rtol=tentry.tol, atol=tentry.tol)


@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
def test_streamcluster_ndirty_counts_distinct_claimed_centres(backend):
    # the oracle does not return ndirty: hold it against the JAX run and
    # against the number of distinct centres that switchers leave
    jout, want = _jax_run("streamcluster", "loop")
    out, _ = _port_run("streamcluster", backend)
    args = _entries("streamcluster")[0].make_args(np.random.default_rng(42))
    moved = np.unique(args["assign"][want["switched"] == 1])
    assert out["ndirty"].tolist() == jout["ndirty"].tolist() == [moved.size]
    k = args["dirty"].size
    assert out["dirty"].shape == (k,)       # no slot past k
    np.testing.assert_array_equal(np.flatnonzero(out["dirty"]), moved)


@pytest.mark.parametrize("name,bad", [
    ("backprop_layer", {"block": 32}),
    ("backprop_layer", {"grid": 17}),
    ("lud_diag", {"block": 8}),
    ("lud_diag", {"grid": 9}),
    ("lavamd", {"block": 16}),
    ("lavamd", {"grid": 9}),
    ("streamcluster", {"block": 48, "grid": 6}),
    ("vecadd", {"block": (64, 2)}),
    ("reverse", {"grid": (2, 2)}),
    ("reverse", {"block": 1024}),
    ("histogram_coalesced", {"grid": (4, 4)}),
    ("reduce_shared", {"block": 128}),
    ("reduce_warp", {"block": 48}),
    ("reduce_warp", {"block": 128}),
    ("matmul_tiled", {"block": 32}),
    ("matmul_tiled", {"grid": 17}),
    ("stencil1d", {"block": 64}),
    ("stencil1d", {"grid": (16, 2)}),
    ("stencil2d", {"block": 64}),
    ("stencil2d", {"block": (16, 4)}),
    ("stencil2d", {"grid": (8, 4, 2)}),
    ("softmax_row", {"grid": 33}),
    ("softmax_row", {"block": 64}),
    ("scan_block", {"grid": 9}),
    ("scan_block", {"block": 64}),
    ("transpose_tiled", {"grid": 65}),
    ("transpose_tiled", {"block": 32}),
    ("pixel_pipeline", {"grid": 33}),
    ("pixel_pipeline", {"block": 256})])
def test_single_launch_wrappers_reject_geometry_they_cannot_run(name, bad):
    _, tstep, args = _step_state(name)
    kern = lower_cuda.KERNELS[name]
    geom = {"grid": tstep.grid, "block": tstep.block, **bad}
    with pytest.raises(UnsupportedKernel):
        kern(carry.from_reference(args, device="cpu"), **geom,
             **lower_cuda.launch_params(tstep.kernel, tstep.dyn_shared))


def test_wrappers_reject_sizes_their_kernels_cannot_hold():
    with pytest.raises(UnsupportedKernel, match="inputs per thread"):
        lower_cuda.KERNELS["backprop_layer"].check(
            Dim3(1), Dim3(131072), {"in_n": 131072, "out_n": 1})
    with pytest.raises(UnsupportedKernel, match="at most 32"):
        lower_cuda.KERNELS["lud_diag"].check(Dim3(1), Dim3(64),
                                             {"ntiles": 1, "b": 64})
    with pytest.raises(ValueError, match="power of two"):
        cuda_suite.make_backprop_layer(48, 4)


@functools.cache
def _nn_tie_args():
    # records on a lattice around the target (30, 90): many distances are
    # exactly equal, and each nearest slot has several candidates
    jentry, _ = _entries("nn", knn=3)
    args = jentry.make_args(np.random.default_rng(42))
    r = np.random.default_rng(7)
    n = args["lat"].size
    off = np.asarray([-3.0, -1.0, 1.0, 3.0], np.float32)
    args["lat"] = (30.0 + r.choice(off, n)).astype(np.float32)
    args["lng"] = (90.0 + r.choice(off, n)).astype(np.float32)
    return args


@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
def test_nn_equal_distances_go_to_the_lowest_record_index(backend):
    args = _nn_tie_args()
    jentry, tentry = _entries("nn", knn=3)
    d = (args["lat"] - 30.0) ** 2 + (args["lng"] - 90.0) ** 2
    assert (d == d.min()).sum() > 3           # every slot is a tie
    out, want = cuda_suite.run_entry(tentry, backend, args=args,
                                     device="cpu")
    first = np.flatnonzero(d == d.min())[:3]  # np.argmin's picks, in order
    np.testing.assert_array_equal(want["out_i"], first)
    jout, _ = jsuite.run_entry(jentry, "loop", args=args)
    for k in ("out_i", "taken"):
        np.testing.assert_array_equal(_np(out[k]), want[k], err_msg=k)
        np.testing.assert_array_equal(_np(out[k]), np.asarray(jout[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(_np(out["out_d"]), want["out_d"])


def _nn_reduce_nan_args(n: int, block: int) -> dict:
    """nn_reduce's buffers with ``lat`` NaN at block 0's first record,
    across all of block 1, and at one record of block 2 (t = 77 where the
    block holds it, a lane's third register; its last record otherwise),
    and an eighth of the records taken."""
    r = np.random.default_rng(n + block)
    lat = r.uniform(0.0, 90.0, n).astype(np.float32)
    lat[[0, 2 * block + min(77, block - 1)]] = np.nan
    lat[block:2 * block] = np.nan
    taken = np.zeros(n, np.int32)
    taken[r.choice(n, n // 8, replace=False)] = 1
    taken[0] = 0
    return {"lat": lat, "lng": r.uniform(0.0, 180.0, n).astype(np.float32),
            "target": np.asarray([30.0, 90.0], np.float32), "taken": taken,
            "pval": np.zeros(n // block, np.float32),
            "pidx": np.zeros(n // block, np.int32)}


@functools.cache
def _jax_nn_reduce_nan(n: int, block: int) -> dict:
    want = japi.launch(jsuite.make_nn_reduce(n, block), grid=n // block,
                       block=block, backend="loop",
                       args={k: jnp.asarray(v) for k, v in
                             _nn_reduce_nan_args(n, block).items()})
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("backend", ("cuda", "loop", "vector"))
@pytest.mark.parametrize("n,block", [(64, 16), (1024, 256)])
def test_nn_reduce_with_nan_distances_follows_the_reference_tree(
        n, block, backend):
    # F6: a NaN on the tree's left is never replaced and one on its right
    # never taken, so a block's pair depends on where the NaN sits: block
    # 0 (NaN first) and block 1 (all NaN) keep their first record's NaN,
    # block 2 drops its NaN.  The port's cuda (its plain version on the
    # CPU), loop and vector give the reference loop launch's pidx exactly
    # and its pval with NaN in the same places (np.argmin's first-NaN pick
    # is no expectation here)
    args = _nn_reduce_nan_args(n, block)
    want = _jax_nn_reduce_nan(n, block)
    assert np.isnan(want["pval"]).tolist() == [True, True, False, False]
    assert want["pidx"][:2].tolist() == [0, block]
    got = launch(cuda_suite.make_nn_reduce(n, block), grid=n // block,
                 block=block, args=carry.from_reference(args, device="cpu"),
                 backend=backend)
    _assert_match("nn_reduce", got, want, ("pval", "pidx"))


@pytest.mark.parametrize("backend", ("cuda", "loop", "vector"))
@pytest.mark.parametrize("step", (1, -2, 9))
def test_nn_select_with_nan_partials_follows_the_reference_tree(step,
                                                                backend):
    # 16 partials with NaN on both sides of the tree's pairs and ties on
    # the value; step in range, wrapped once and dropped
    r = np.random.default_rng(3)
    pval = r.choice(np.asarray([1.0, 2.0, 4.0], np.float32), 16)
    pval[[3, 8, 10]] = np.nan
    args = {"pval": pval,
            "pidx": r.permutation(16 * 64)[:16].astype(np.int32),
            "step": np.asarray([step], np.int32),
            "out_d": np.zeros(4, np.float32),
            "out_i": np.zeros(4, np.int32),
            "taken": np.zeros(16 * 64, np.int32)}
    want = japi.launch(jsuite.make_nn_select(16), grid=1, block=16,
                       backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    got = launch(cuda_suite.make_nn_select(16), grid=1, block=16,
                 args=carry.from_reference(args, device="cpu"),
                 backend=backend)
    _assert_match("nn_select", got, want, ("out_d", "out_i", "taken"))


@functools.cache
def _nn_nan_entry_args():
    jentry, _ = _entries("nn", n=256, block=64, knn=4)
    args = jentry.make_args(np.random.default_rng(42))
    args["lat"][[5, 70]] = np.nan
    return args


@functools.cache
def _jax_nn_nan_run():
    jentry, _ = _entries("nn", n=256, block=64, knn=4)
    out, _ = jsuite.run_entry(jentry, "loop", args=_nn_nan_entry_args(),
                              with_reference=False)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("backend", ("cuda", "loop", "vector"))
def test_nn_entry_with_nan_records_equals_the_reference(backend):
    # F6 through the whole chain: with lat[5] and lat[70] NaN the
    # reference's kernels pick records 32, 47, 248 and 67; the port's
    # cuda once gave INT_MAX four times and took nothing
    _, tentry = _entries("nn", n=256, block=64, knn=4)
    out, _ = cuda_suite.run_entry(tentry, backend,
                                  args=_nn_nan_entry_args(),
                                  with_reference=False, device="cpu")
    jout = _jax_nn_nan_run()
    np.testing.assert_array_equal(jout["out_i"], [32, 47, 248, 67])
    for k in ("out_i", "taken"):
        np.testing.assert_array_equal(_np(out[k]), jout[k], err_msg=k)
    _assert_match("nn", out, jout, ("out_d",))


KMEANS_RUNS = [({}, 42), ({}, 7), ({"n": 512, "k": 3}, 7),
               ({"n": 2048, "repeat": 3}, 7)]


@functools.cache
def _jax_kmeans_stats(i):
    kw, seed = KMEANS_RUNS[i]
    jentry, _ = _entries("kmeans", **kw)
    stats = jsuite.ChainStats()
    out, _ = jsuite.run_entry(jentry, "loop", chain_stats=stats,
                              rng=np.random.default_rng(seed))
    return stats, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
@pytest.mark.parametrize("i", range(len(KMEANS_RUNS)),
                         ids=["n256-s42", "n256-s7", "n512-k3-s7",
                              "n2048-r3-s7"])
def test_kmeans_chain_counts_equal_the_reference(i, backend):
    # converged after 2 or 3 iterations, cut by the repeat bound while
    # still moving (k = 3 never settles from these starting centroids),
    # and cut by repeat = 3: the stop flag is read back once per
    # iteration after the first, as the reference's host mode does
    kw, seed = KMEANS_RUNS[i]
    jstats, jout = _jax_kmeans_stats(i)
    _, tentry = _entries("kmeans", **kw)
    stats = cuda_suite.ChainStats()
    out, want = cuda_suite.run_entry(tentry, backend, chain_stats=stats,
                                     rng=np.random.default_rng(seed),
                                     device="cpu")
    assert (stats.iterations, stats.launches, stats.host_syncs) == (
        jstats.iterations, jstats.launches, jstats.host_syncs)
    _assert_match("kmeans", out, jout, jout.keys())
    _assert_match("kmeans", out, want, want.keys())


@pytest.mark.parametrize("name,bad", [
    ("srad_stats", {"block": 96}),
    ("nn_reduce", {"block": 48}),
    ("nn_select", {"block": 2}),
    ("kmeans_assign", {"block": 48}),
    ("kmeans_update", {"grid": 3})])
def test_chain_wrappers_reject_geometry_they_cannot_run(name, bad):
    _, tstep, args = _step_state(name)
    kern = lower_cuda.KERNELS[name]
    geom = {"grid": tstep.grid, "block": tstep.block, **bad}
    with pytest.raises(UnsupportedKernel):
        kern(carry.from_reference(args, device="cpu"), **geom,
             **dict(tstep.kernel.native.params))


def test_chain_wrappers_reject_sizes_their_kernels_cannot_hold():
    kerns = lower_cuda.KERNELS
    with pytest.raises(UnsupportedKernel, match="power of two up to 1024"):
        kerns["nn_select"].check(Dim3(1), Dim3(2048), {"nblocks": 2048})
    with pytest.raises(UnsupportedKernel, match="power of two"):
        kerns["srad_stats"].check(Dim3(16), Dim3(128),
                                  {"h": 32, "w": 64, "nthreads": 64})
    with pytest.raises(UnsupportedKernel, match="clusters"):
        kerns["kmeans_assign"].check(Dim3(4), Dim3(64),
                                     {"n": 256, "k": 33})
    with pytest.raises(UnsupportedKernel, match="8x8"):
        kerns["srad_update"].check(Dim3(8, 4), Dim3(16, 4), {})
    for make in (lambda: cuda_suite.make_srad_stats(32, 64, 96),
                 lambda: cuda_suite.make_nn_reduce(256, 48),
                 lambda: cuda_suite.make_nn_select(6)):
        with pytest.raises(ValueError, match="power of two"):
            make()


@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
@pytest.mark.parametrize("grid", (None, 5))
def test_histogram_contiguous_layout_matches_reference(backend, grid):
    # each thread counts iters neighbouring pixels (Fig. 10c); under a
    # smaller grid only the pixels of the threads that run are counted
    n, nbins, g, b = 4096, 64, 16, 128
    jkernel = jsuite.make_histogram(n, nbins, g * b, layout="contiguous")
    tentry = cuda_suite.entry_histogram(layout="contiguous")
    assert tentry.kernel.name == jkernel.name == "histogram_contiguous"
    args = tentry.make_args(np.random.default_rng(42))
    want = japi.launch(jkernel, grid=grid or g, block=b,
                       args={k: jnp.asarray(v) for k, v in args.items()},
                       backend="loop")
    out, oracle = cuda_suite.run_entry(tentry, backend, args=args,
                                       grid=grid, device="cpu")
    _assert_match("histogram", out, want, ("hist",))
    if grid is None:
        np.testing.assert_array_equal(_np(out["hist"]), oracle["hist"])
    else:
        assert int(out["hist"].sum()) == grid * b * (n // (g * b))


@pytest.mark.parametrize("dyn", (512, 768))
def test_reverse_extern_shared_follows_the_dyn_shared_slot(dyn):
    # the shared array has dyn elements: past the block they hold the
    # reference's zeros, and d[t] reads s[dyn - 1 - t]
    jentry, tentry = _entries("reverse")
    args = tentry.make_args(np.random.default_rng(42))
    want = japi.launch(jentry.kernel, grid=1, block=512, dyn_shared=dyn,
                       args={"d": jnp.asarray(args["d"])}, backend="loop")
    for backend in ("vector", "loop", "cuda"):
        got = tentry.kernel[1, 512, dyn].on(backend=backend)(
            d=torch.from_numpy(args["d"]))
        _assert_match("reverse", got, want, ("d",))
    if dyn > 512:
        assert (np.asarray(want["d"])[:dyn - 512] == 0).all()


@pytest.mark.parametrize("grid", (2, 3))
@pytest.mark.parametrize("block,dyn", ((512, 512), (256, 640)))
def test_reverse_blocks_reverse_the_same_d_in_turn(grid, block, dyn):
    # the reference's g blocks apply the one-block reversal to d one after
    # another: twice gives d back where ns equals the block
    jentry, tentry = _entries("reverse")
    args = tentry.make_args(np.random.default_rng(42))
    want = japi.launch(jentry.kernel, grid=grid, block=block,
                       dyn_shared=dyn, args={"d": jnp.asarray(args["d"])},
                       backend="loop")
    got = tentry.kernel[grid, block, dyn].on(backend="cuda")(
        d=torch.from_numpy(args["d"]))
    _assert_match("reverse", got, want, ("d",))
    if grid == 2 and block == dyn:
        np.testing.assert_array_equal(_np(got["d"]), args["d"])


#: reverse's blocks and the extents past them (ns - B): one thread, a
#: ragged warp, a warp, three warps, CUDA's widest block; ns = B, and the
#: window [ns - B, B) cut by 1, 5 and 300 cells, or empty
REVERSE_BLOCKS = (1, 31, 32, 96, 1024)
REVERSE_EXTRA = (0, 1, 5, 300, 2100)


@pytest.mark.parametrize("grid", (1, 4, 7))
@pytest.mark.parametrize("extra", REVERSE_EXTRA)
@pytest.mark.parametrize("block", REVERSE_BLOCKS)
def test_reverse_grids_of_passes_match_the_reference(block, extra, grid):
    # one pass, an even and an odd count of them over d[1024]; the cells
    # at the block and past it keep their values
    tkernel = cuda_suite.entry_reverse(n=1024).kernel
    d = np.random.default_rng(block * 10 + extra).integers(
        -50, 50, 1024).astype(np.int32)
    ns = block + extra
    want = japi.launch(jsuite.make_reverse(), grid=grid, block=block,
                       dyn_shared=ns, args={"d": jnp.asarray(d)},
                       backend="loop")
    for backend in ("vector", "loop", "cuda"):
        got = tkernel[grid, block, ns].on(backend=backend)(
            d=torch.from_numpy(d))
        _assert_match("reverse", got, want, ("d",))
    np.testing.assert_array_equal(np.asarray(want["d"])[block:], d[block:])


def _reverse_closed_form(d, block, ns, grid):
    """``grid`` passes of one block over ``d`` in closed form: zeros
    below lo = min(ns - block, block), the window [lo, block) reversed in
    place for an odd count of passes and kept for an even one."""
    out = d.copy()
    lo = min(ns - block, block)
    out[:lo] = 0
    if grid % 2:
        out[lo:block] = d[lo:block][::-1]
    return out


@pytest.mark.parametrize("grid", (1, 2, 3, 4, 7))
@pytest.mark.parametrize("block", (1, 2, 31, 32, 96, 256, 1024))
def test_reverse_plain_equals_the_closed_form(block, grid):
    # the rule csrc/reverse.cu computes, held against the plain version,
    # which runs the passes one by one
    kern = lower_cuda.KERNELS["reverse"]
    for extra in (0, 1, 5, 300, 1024, 2100):
        d = np.random.default_rng(extra).integers(0, 100, 1100).astype(
            np.int32)
        ns = block + extra
        got = kern.plain({"d": torch.from_numpy(d)}, Dim3(grid),
                         Dim3(block), n=1100, dyn_shared=ns)["d"]
        np.testing.assert_array_equal(
            got.numpy(), _reverse_closed_form(d, block, ns, grid),
            err_msg=f"extra {extra}")


def _same_float_bits(got, want, err_msg=""):
    """float32 arrays equal as int32 bit patterns, a NaN matching a NaN
    in the same place."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan, err_msg=err_msg)
    np.testing.assert_array_equal(g.view(np.int32)[~nan],
                                  w.view(np.int32)[~nan], err_msg=err_msg)


#: kmeans_update's buffers off the entry's path: a negative count divides
#: by 1 and a zero count keeps its centroid (the reference's rule); counts
#: past 2^24, where the count's float rounds; NaN and signed-zero sums
KMEANS_UPDATE_CASES = {
    "negative": {"sumx": [6, 5, 9, 10], "sumy": [4, 1, 3, 7],
                 "count": [-2, 0, 3, 5], "cx": [1, 2, 3, 4],
                 "cy": [5, 6, 7, 8]},
    "large": {"sumx": [16777217, 3e7, -5e9, 7, 1e30, 0],
              "sumy": [1, -1, 2.5, -7, 3, 1e-30],
              "count": [1 << 24, (1 << 24) + 1, (1 << 25) + 3,
                        -(1 << 25) - 3, 0x7FFFFFFF, -(1 << 31)],
              "cx": [0.5] * 6, "cy": [-0.5] * 6},
    "nan_and_zeros": {"sumx": [0.0, -0.0, np.nan, -0.0, np.nan, 4],
                      "sumy": [-0.0, np.nan, 0.0, -0.0, 2, -np.nan],
                      "count": [1, 3, -1, -4, 0, 2],
                      "cx": [9, 9, 9, 9, np.nan, 9],
                      "cy": [-0.0, 1, 1, 1, 1, 1]},
}


@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
@pytest.mark.parametrize("case", tuple(KMEANS_UPDATE_CASES))
def test_kmeans_update_counts_off_the_path_match_the_reference(case,
                                                               backend):
    host = {name: np.asarray(v, np.int32 if name == "count" else np.float32)
            for name, v in KMEANS_UPDATE_CASES[case].items()}
    k = host["count"].size
    want = japi.launch(jsuite.make_kmeans_update(k), grid=k, block=8,
                       args={n: jnp.asarray(v) for n, v in host.items()},
                       backend="loop")
    got = cuda_suite.make_kmeans_update(k)[k, 8].on(backend=backend)(
        **{n: torch.from_numpy(v) for n, v in host.items()})
    for name in ("cx", "cy"):
        _same_float_bits(_np(got[name]), np.asarray(want[name]), name)
    if case == "negative":
        np.testing.assert_array_equal(_np(got["cx"]),
                                      np.float32([6, 2, 3, 2]))
        np.testing.assert_array_equal(_np(got["cy"]),
                                      np.float32([4, 6, 1, 1.4]))


def test_reverse_wrapper_refuses_a_shared_array_smaller_than_the_block():
    _, tentry = _entries("reverse")
    kern = lower_cuda.KERNELS["reverse"]
    bufs = carry.from_reference(
        tentry.make_args(np.random.default_rng(42)), device="cpu")
    with pytest.raises(UnsupportedKernel, match="smaller than the block"):
        kern(bufs, grid=1, block=512, n=512, dyn_shared=511)
    with pytest.raises(UnsupportedKernel, match="smaller than the block"):
        tentry.kernel[1, 512, 256].on(backend="cuda")(**bufs)
    with pytest.raises(ValueError, match="dyn_shared"):
        tentry.kernel[1, 512].on(backend="cuda")(**bufs)
    with pytest.raises(UnsupportedKernel, match="bytes"):
        kern.check(Dim3(1), Dim3(512), {"n": 512, "dyn_shared": 12289})


def test_dyn_shared_slot_reaches_the_launcher_in_bytes(monkeypatch):
    # the chevron's third slot goes through api -> backends -> lower_cuda
    # to the wrapper, whose C arguments carry it in bytes
    _, tentry = _entries("reverse")
    kern = lower_cuda.KERNELS["reverse"]
    seen = {}
    plain = kern.plain

    def spy(bufs, grid, block, **params):
        seen.update(params)
        return plain(bufs, grid, block, **params)

    monkeypatch.setattr(kern, "plain", spy)
    d = torch.arange(512, dtype=torch.int32)
    tentry.kernel[1, 256, 640].on(backend="cuda")(d=d)
    assert seen == {"n": 512, "dyn_shared": 640}
    cargs = kern.cargs({"d": d}, Dim3(1), Dim3(256), **seen)
    assert cargs[1:] == [1, 256, 640 * 4]
    assert kern.argtypes[3] is ctypes.c_size_t
    assert lower_cuda.launch_params(tentry.kernel, 640) == seen
    # a kernel without an extern array takes no such parameter
    assert "dyn_shared" not in lower_cuda.launch_params(
        _entries("vecadd")[1].kernel, 640)


@pytest.mark.parametrize("n,block", [(2048, 256), (1000, 128), (700, 96),
                                     (3000, 1024), (1000, 32), (2000, 480),
                                     (5000, 1024)])
def test_reduce_warp_plain_version_has_the_reference_loop_bits(n, block):
    # the plain version repeats the butterflies level by level (a sum in
    # another order would differ in the last bits); ragged n loads zeros
    grid = -(-n // block)
    jkernel = jsuite.make_reduce_warp(n, block)
    args = {"x": np.random.default_rng(42).standard_normal(
        n, dtype=np.float32), "out": np.zeros(grid, np.float32)}
    want = japi.launch(jkernel, grid=grid, block=block, backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    kern = lower_cuda.KERNELS["reduce_warp"]
    got = kern(carry.from_reference(args, device="cpu"), grid=grid,
               block=block, n=n, nthreads=block)
    np.testing.assert_array_equal(_np(got["out"]), np.asarray(want["out"]))


@pytest.mark.parametrize("n,block", [(2048, 256), (1000, 128), (100, 1),
                                     (999, 2), (1000, 16), (700, 32),
                                     (3000, 64), (3000, 1024)])
def test_reduce_shared_plain_version_has_the_reference_loop_bits(n, block):
    # the plain version repeats the barrier tree level by level, the order
    # the kernel's register and shuffle levels keep; ragged n loads zeros
    grid = -(-n // block)
    jkernel = jsuite.make_reduce_shared(n, block)
    args = {"x": np.random.default_rng(42).standard_normal(
        n, dtype=np.float32), "out": np.zeros(grid, np.float32)}
    want = japi.launch(jkernel, grid=grid, block=block, backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    kern = lower_cuda.KERNELS["reduce_shared"]
    got = kern(carry.from_reference(args, device="cpu"), grid=grid,
               block=block, n=n, nthreads=block)
    np.testing.assert_array_equal(_np(got["out"]), np.asarray(want["out"]))


@pytest.mark.parametrize("h,w,block", [(4, 25, 1), (5, 21, 2), (6, 30, 16),
                                       (8, 40, 32), (7, 50, 64),
                                       (16, 64, 128), (40, 70, 1024)])
def test_srad_stats_plain_version_has_the_reference_loop_bits(h, w, block):
    # both partials in the barrier tree's order, level by level, the order
    # the kernel's register and shuffle levels keep; a pixel count that is
    # not a multiple of the block loads zeros in the last block, whose
    # partials fall past psum and psq (npix // block long) in both
    npix = h * w
    grid = -(-npix // block)
    jkernel = jsuite.make_srad_stats(h, w, block)
    r = np.random.default_rng(42)
    args = {"x": r.standard_normal((h, w), dtype=np.float32),
            "psum": r.standard_normal(npix // block, dtype=np.float32),
            "psq": r.standard_normal(npix // block, dtype=np.float32)}
    want = japi.launch(jkernel, grid=grid, block=block, backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    kern = lower_cuda.KERNELS["srad_stats"]
    got = kern(carry.from_reference(args, device="cpu"), grid=grid,
               block=block, h=h, w=w, nthreads=block)
    for name in ("psum", "psq"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]))


@pytest.mark.parametrize("rows,block,grid", [(9, 32, 9), (9, 96, 9),
                                             (5, 1024, 5), (12, 32, 7),
                                             (10, 96, 3), (4, 1024, 1)])
def test_softmax_row_plain_version_at_the_widths_the_kernel_dispatches(
        rows, block, grid):
    # B = 32 (one value a lane), 96 (three, one float an access) and 1024
    # (32 a lane, float4s): the plain version agrees with the reference's
    # loop launch within the entry's tol, and the rows past the grid keep
    # y's input bits in both
    entry = cuda_suite.entry_softmax_row(rows, block)
    r = np.random.default_rng(42)
    args = {"x": 3 * r.standard_normal((rows, block), dtype=np.float32),
            "y": r.standard_normal((rows, block), dtype=np.float32)}
    want = japi.launch(jsuite.make_softmax_row(block), grid=grid,
                       block=block, backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    kern = lower_cuda.KERNELS["softmax_row"]
    got = kern(carry.from_reference(args, device="cpu"), grid=grid,
               block=block, **dict(entry.kernel.native.params))
    got, want = _np(got["y"]), np.asarray(want["y"])
    np.testing.assert_array_equal(got[grid:], args["y"][grid:])
    np.testing.assert_array_equal(want[grid:], args["y"][grid:])
    np.testing.assert_allclose(got, want, rtol=entry.tol, atol=entry.tol)
    np.testing.assert_allclose(got[:grid].sum(1), 1.0, rtol=entry.tol)


@pytest.mark.parametrize("m,n,grid", [(16, 24, 5), (24, 40, 7)])
def test_matmul_tiled_plain_version_at_a_partial_grid(m, n, grid):
    # m != n and a grid that ends inside a tile row: the covered tiles
    # agree with the reference's loop launch within the entry's tol, the
    # rest keep c's input bits in both
    k = 16
    entry = cuda_suite.entry_matmul_tiled(m, n, k)
    assert grid % (n // 8) and grid < entry.grid
    args = entry.make_args(np.random.default_rng(42))
    args["c"] = np.random.default_rng(7).standard_normal((m, n),
                                                         dtype=np.float32)
    want = japi.launch(jsuite.make_matmul_tiled(m, n, k), grid=grid,
                       block=64, backend="loop",
                       args={name: jnp.asarray(v) for name, v in args.items()})
    kern = lower_cuda.KERNELS["matmul_tiled"]
    got = kern(carry.from_reference(args, device="cpu"), grid=grid,
               block=64, m=m, n=n, k=k)
    got, want = _np(got["c"]), np.asarray(want["c"])
    tile = (np.arange(m)[:, None] // 8) * (n // 8) + np.arange(n) // 8
    np.testing.assert_array_equal(got[tile >= grid], args["c"][tile >= grid])
    np.testing.assert_array_equal(want[tile >= grid],
                                  args["c"][tile >= grid])
    np.testing.assert_allclose(got, want, rtol=entry.tol, atol=entry.tol)


def test_matmul_tiled_plain_version_within_tol_of_float64_at_depth_2048():
    m = n = 64
    k = 2048
    entry = cuda_suite.entry_matmul_tiled(m, n, k)
    assert entry.tol == cuda_suite.matmul_tol(k) > 2e-5
    assert cuda_suite.matmul_tol(32) == 2e-5 == _entries(
        "matmul_tiled")[0].tol
    args = entry.make_args(np.random.default_rng(42))
    kern = lower_cuda.KERNELS["matmul_tiled"]
    got = kern(carry.from_reference(args, device="cpu"), grid=entry.grid,
               block=entry.block, **dict(entry.kernel.native.params))
    exact = args["a"].astype(np.float64) @ args["b"].astype(np.float64)
    np.testing.assert_allclose(_np(got["c"]), exact, rtol=entry.tol,
                               atol=entry.tol)


def test_textbook_wrappers_reject_sizes_their_kernels_cannot_hold():
    kerns = lower_cuda.KERNELS
    with pytest.raises(UnsupportedKernel, match="bins"):
        kerns["histogram_coalesced"].check(
            Dim3(16), Dim3(128), {"n": 4096, "nbins": 20000,
                                  "total_threads": 2048})
    with pytest.raises(UnsupportedKernel, match="multiples of 8"):
        kerns["matmul_tiled"].check(Dim3(1), Dim3(64),
                                    {"m": 12, "n": 8, "k": 8})
    with pytest.raises(UnsupportedKernel, match="multiple of 32"):
        kerns["softmax_row"].check(Dim3(4), Dim3(48),
                                   {"rows": 4, "nthreads": 48})
    with pytest.raises(UnsupportedKernel, match="multiples of 8"):
        kerns["transpose_tiled"].check(Dim3(1), Dim3(64), {"h": 12, "w": 8})
    with pytest.raises(UnsupportedKernel, match="up to 1024"):
        kerns["pixel_pipeline"].check(Dim3(1), Dim3(2048),
                                      {"n": 4096, "nthreads": 2048})
    for make in (lambda: cuda_suite.make_reduce_shared(256, 96),
                 lambda: cuda_suite.make_matmul_tiled(12, 8, 8),
                 lambda: cuda_suite.make_histogram(64, 8, 32, "strided"),
                 lambda: cuda_suite.make_scan_block(1024, 96),
                 lambda: cuda_suite.make_transpose_tiled(12, 8),
                 lambda: cuda_suite.entry_scan_block(1000),
                 lambda: cuda_suite.entry_pixel_pipeline(1000)):
        with pytest.raises(ValueError):
            make()


@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
def test_stencil1d_at_a_ragged_n_matches_the_reference(backend):
    # 4000 = 31.25 blocks of 128: the last block's reads past n clamp to
    # x[n-1], its stores past n are dropped
    n, block = 4000, 128
    tentry = cuda_suite.entry_stencil1d(n, block)
    assert tentry.grid * block > n
    args = tentry.make_args(np.random.default_rng(42))
    want = japi.launch(jsuite.make_stencil1d(n, block), grid=tentry.grid,
                       block=block, backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    out, oracle = cuda_suite.run_entry(tentry, backend, args=args,
                                       device="cpu")
    np.testing.assert_array_equal(_np(out["y"]), np.asarray(want["y"]))
    np.testing.assert_array_equal(_np(out["y"]), oracle["y"])


@pytest.mark.parametrize("backend", ("vector", "loop", "cuda"))
def test_scan_block_adds_the_reference_zero_below_each_offset(backend):
    # thread t < d adds 0.0 at level d, as the reference does, so where a
    # -0.0 meets that 0.0 it comes out +0.0; a scan that skipped the add
    # would keep -0.0 there
    _, tentry = _entries("scan_block")
    args = tentry.make_args(np.random.default_rng(42))
    args["x"][:256] = -0.0
    want = japi.launch(_entries("scan_block")[0].kernel, grid=tentry.grid,
                       block=tentry.block, backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    out, _ = cuda_suite.run_entry(tentry, backend, args=args, device="cpu")
    got, want = _np(out["y"]), np.asarray(want["y"])
    assert 0 < np.signbit(want[:256]).sum() < 256
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(got, want)


def _lud_pivot_tiles(b, pivot):
    """Two diagonally dominant tiles of b; the first meets a zero pivot at
    step 1 (rows [1, 2, 3, 4] and [2, 4, 5, 1] on top) or a NaN one (a NaN
    at (1, 1))."""
    r = np.random.default_rng(42)
    tiles = 0.1 * r.standard_normal((2, b, b)).astype(np.float32)
    tiles += 4.0 * np.eye(b, dtype=np.float32)
    if pivot == "zero":
        tiles[0, 0, :4] = [1, 2, 3, 4]
        tiles[0, 1, :4] = [2, 4, 5, 1]
    else:
        tiles[0, 1, 1] = np.nan
    return {"a": tiles.reshape(2 * b, b),
            "lu": np.zeros((2 * b, b), np.float32)}


@pytest.mark.parametrize("path", ("plain", "vector"))
@pytest.mark.parametrize("pivot", ("zero", "nan"))
@pytest.mark.parametrize("b", (4, 16))
def test_lud_diag_meets_a_zero_or_nan_pivot_as_the_reference(b, pivot,
                                                             path):
    # below a zero or NaN pivot m is infinite or NaN, and the reference's
    # step takes s[i][c] - m * 0 for every column c < k too, so those come
    # out NaN; the port's plain version (the kernel's rule on the card) and
    # its vector lowering give NaN where the reference's loop launch does,
    # and its values within the entry's tol elsewhere
    args = _lud_pivot_tiles(b, pivot)
    want = japi.launch(jsuite.make_lud_diag(2, b), grid=2, block=b,
                       backend="loop",
                       args={k: jnp.asarray(v) for k, v in args.items()})
    bufs = carry.from_reference(args, device="cpu")
    if path == "plain":
        got = lower_cuda.KERNELS["lud_diag"](bufs, grid=2, block=b,
                                             ntiles=2, b=b)
    else:
        got = launch(cuda_suite.make_lud_diag(2, b), grid=2, block=b,
                     args=bufs, backend="vector")
    got, want = _np(got["lu"]), np.asarray(want["lu"])
    assert np.isnan(want[2:b, 0]).all() and np.isfinite(want[b:]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    tol = _tol("lud_diag")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
