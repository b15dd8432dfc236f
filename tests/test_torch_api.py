"""The port's runtime surface: launch API and cache, backends, memory,
``carry``, and the small modules it keeps its own copies of."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dim3 as jdim3  # noqa: E402
from repro.core import grain as jgrain  # noqa: E402
from repro.core import rodinia_io as jio  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import (  # noqa: E402
    api,
    backends,
    cuda_suite,
    grain,
    packing,
    rodinia_io,
)
from repro_torch.core.dim3 import Dim3  # noqa: E402
from repro_torch.core.kernel import (  # noqa: E402
    ChainStats,
    ChainStep,
    KernelDef,
    LaunchChain,
    Native,
    UnsupportedKernel,
)
from repro_torch.core.memory import (  # noqa: E402
    ConstArray,
    CudaError,
    DeviceBuffer,
    Space,
    UnsupportedSpace,
    cuda_free,
    cuda_malloc,
    cuda_memcpy_d2h,
    cuda_memcpy_h2d,
    cuda_memcpy_to_symbol,
)


def _add_one():
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        from repro_torch.core import index
        x = st.glob["x"]
        return st.set_glob(x=index.put(x, gid, index.take(x, gid) + 1))
    return KernelDef("add_one", (stage,), writes=("x",), reads=("x",),
                     donates=("x",))


@pytest.mark.parametrize("v", [5, (3,), (2, 3), (2, 3, 4), Dim3(4, 2)])
def test_dim3_matches_reference(v):
    mine, ref = Dim3.of(v), jdim3.Dim3.of(v)
    assert tuple(mine) == tuple(ref) and mine.size == ref.size
    for lin in range(mine.size):
        assert mine.coords(lin) == ref.coords(lin)
        assert mine.linear(*mine.coords(lin)) == lin


@pytest.mark.parametrize("bad", [0, (1, 0), (1, 2, 3, 4), -2])
def test_dim3_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        Dim3.of(bad)
    with pytest.raises(ValueError):
        jdim3.Dim3.of(bad)


@pytest.mark.parametrize("grid,pool,work", [(64, 8, 3e2), (7, 4, 1e7),
                                            (1000, 132, 2.6e5)])
def test_grain_policies_match_reference(grid, pool, work):
    assert grain.average_grain(grid, pool) == jgrain.average_grain(grid, pool)
    assert grain.heuristic_grain(grid, pool, work) == \
        jgrain.heuristic_grain(grid, pool, work)
    g = grain.heuristic_grain(grid, pool, work)
    assert grain.schedule_trace(grid, pool, g) == \
        grain.ScheduleTrace(**vars(jgrain.schedule_trace(grid, pool, g)))


def test_rodinia_io_matches_reference():
    r = np.random.default_rng(42)
    grid = r.uniform(0, 100, (5, 7)).astype(np.float32)
    text = rodinia_io.format_grid(grid)
    assert text == jio.format_grid(grid)
    np.testing.assert_array_equal(rodinia_io.parse_grid(text, 5, 7),
                                  jio.parse_grid(text, 5, 7))
    lat, lng = r.uniform(-90, 90, 6), r.uniform(-180, 180, 6)
    rec = rodinia_io.format_records(lat, lng)
    assert rec == jio.format_records(lat, lng)
    for a, b in zip(rodinia_io.parse_records(rec), jio.parse_records(rec),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="line 2"):
        rodinia_io.parse_grid("1.0\nx\n", 1, 2)


def test_packing_round_trip_in_sorted_name_order():
    args = {"b": torch.ones(2), "a": torch.zeros(3)}
    leaves, names = packing.pack(args)
    assert names == ("a", "b") and leaves[0] is args["a"]
    assert packing.unpack(leaves, names) == args


def test_backend_registry_holds_the_ported_backends():
    assert backends.backend_names() == ("loop", "loop_nowarp", "naive",
                                        "vector", "cuda")
    assert backends.get_backend("cuda").supports("native")
    assert not backends.get_backend("naive").supports("barrier")
    with pytest.raises(backends.UnknownBackend):
        backends.get_backend("pallas")
    with pytest.raises(ValueError, match="already registered"):
        backends.register_backend("loop", lambda **kw: kw)


def test_launch_cache_hits_misses_and_evictions():
    api.cache_clear()
    k = _add_one()
    x = torch.zeros(64, dtype=torch.int32)
    out = api.launch(k, grid=2, block=32, args={"x": x})
    assert api.cache_stats().misses == 1 and int(out["x"].sum()) == 64
    api.launch(k, grid=2, block=32, args={"x": out["x"]})
    assert api.cache_stats().hits == 1
    api.launch(k, grid=2, block=32, args={"x": x}, backend="loop")
    assert api.cache_size() == 2
    api.cache_resize(1)
    try:
        assert api.cache_stats().evictions == 1 and api.cache_size() == 1
        entry = api.compiled(k, grid=2, block=32, args={"x": x})
        assert entry.backend == "vector" and entry.grid == Dim3(2)
    finally:
        api.cache_resize(256)
        api.cache_clear()
    assert api.cache_stats() == api.CacheStats()
    with pytest.raises(ValueError):
        api.cache_resize(0)


def test_grain_policies_give_the_same_result():
    k = _add_one()
    x = torch.arange(256, dtype=torch.int32)
    want = api.launch(k, grid=8, block=32, args={"x": x})["x"]
    for g in (3, "average", "aggressive"):
        got = api.launch(k, grid=8, block=32, args={"x": x}, grain=g)["x"]
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="grain policy"):
        api.launch(k, grid=8, block=32, args={"x": x}, grain="greedy")


@pytest.mark.parametrize("call", [
    lambda k, a: api.launch(k, grid=1, block=32, args=a, devices=2),
    lambda k, a: api.compiled(k, grid=1, block=32, args=a, shard_axis="x"),
    lambda k, a: k[1, 32].on(shard_axis="x")(a)])
def test_options_not_ported_yet_raise(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(_add_one(), {"x": torch.zeros(32, dtype=torch.int32)})


def test_only_the_shard_options_are_refused():
    assert set(api.NOT_PORTED) == {"devices", "shard_axis"}
    assert all(v.startswith("ROADMAP 1.12") for v in api.NOT_PORTED.values())
    assert {"launch_batch", "enable_disk_cache",
            "disable_disk_cache"} <= set(api.__all__)


def _fusable():
    """Two stages that touch only their own thread's elements: kernelcheck
    proves the barrier between them removable."""
    from repro_torch.core import index

    def double(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        y = index.put(st.glob["y"], gid, index.take(st.glob["x"], gid) * 2)
        return st.set_glob(y=y)

    def bump(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        y = st.glob["y"]
        return st.set_glob(y=index.put(y, gid, index.take(y, gid) + 1))

    return KernelDef("fusable", (double, bump), writes=("y",),
                     reads=("x", "y"))


def _surface(how: str, k, args: dict, **opts) -> dict:
    """One launch of ``k`` over ``args`` (grid 2 x 32) through ``how``."""
    from repro_torch.core.streams import Stream

    if how == "launch":
        return api.launch(k, grid=2, block=32, args=args, **opts)
    if how == "chevrons":
        return k[2, 32].on(**opts)(args)
    if how == "compiled":
        entry = api.compiled(k, grid=2, block=32, args=args, **opts)
        leaves, _ = packing.pack(args)
        return entry(*leaves)
    s = Stream(dict(args))
    if how == "stream":
        s.launch(k, grid=2, block=32, **opts)
    else:                                   # a graph captured, replayed
        s.begin_capture()
        s.launch(k, grid=2, block=32, **opts)
        s.end_capture().instantiate(s.buffers).launch(s)
    s.synchronize()
    return dict(s.buffers)


SURFACES = ("launch", "chevrons", "compiled", "stream", "graph")


@pytest.mark.parametrize("how", SURFACES)
def test_optimize_on_every_launch_surface(how, monkeypatch):
    """``optimize=True`` (and ``CUPBOP_OPTIMIZE=1``) swap in the derived
    kernel on launch, the chevrons, compiled, Stream.launch and a graph's
    capture; the bits are the base kernel's."""
    from repro_torch.core.optimize import OptimizedKernel

    args = {"x": torch.arange(64.0), "y": torch.zeros(64)}
    want = _surface(how, _fusable(), args)["y"]
    assert want.tolist() == [2.0 * i + 1 for i in range(64)]
    for opts, env in (({"optimize": True}, None), ({}, "1")):
        k = _fusable()
        if env:
            monkeypatch.setenv("CUPBOP_OPTIMIZE", env)
        got = _surface(how, k, args, **opts)["y"]
        assert torch.equal(got, want)
        derived = list(getattr(k, "_optimize_derived", {}).values())
        assert len(derived) == 1 and isinstance(derived[0], OptimizedKernel)
        assert len(derived[0].stages) == 1
    k = _fusable()
    _surface(how, k, args, optimize=False)
    assert not getattr(k, "_optimize_derived", {})


@pytest.mark.parametrize("how", ["launch", "chevrons"])
def test_sanitize_on_the_launch_surfaces(how, monkeypatch):
    from repro_torch.core.analyze import SanitizerError, planted_race

    kernel, _, _, args = planted_race()
    for opts, env in (({"sanitize": True}, None), ({}, "1")):
        if env:
            monkeypatch.setenv("CUPBOP_SANITIZE", env)
        with pytest.raises(SanitizerError, match="shared-race"):
            _surface(how, kernel, args, **opts)
    _surface(how, kernel, args, sanitize=False)


def test_graph_captures_unoptimized_where_inputs_are_not_yet_on_the_heap():
    from repro_torch.core.streams import Stream

    s = Stream({"x": torch.arange(64.0)})
    graph = s.begin_capture()
    s.memcpy_h2d("y", np.zeros(64, np.float32))   # y comes from the graph
    s.launch(_fusable(), grid=2, block=32, optimize=True)
    s.end_capture()
    (node,) = [n for n in graph.nodes if n.kind == "kernel"]
    assert len(node.kernel.stages) == 2
    graph.instantiate(s.buffers).launch(s)
    s.synchronize()
    assert s.buffers["y"].tolist() == [2.0 * i + 1 for i in range(64)]


def test_chevrons_validate_their_slots():
    k = _add_one()
    with pytest.raises(TypeError, match="launch config"):
        k[1]
    with pytest.raises(TypeError, match="dyn_shared"):
        k[1, 32, "big"]
    with pytest.raises(TypeError, match="unexpected options"):
        k[1, 32].on(colour="red")
    got = k[(2, 1), 32].on(backend="loop", grain=2)(
        {"x": torch.zeros(64, dtype=torch.int32)})
    assert int(got["x"].sum()) == 64


def test_const_buffers_are_read_only_under_every_backend():
    k = _add_one()
    for backend in ("vector", "loop", "cuda"):
        with pytest.raises(UnsupportedSpace, match="read-only"):
            api.launch(k, grid=1, block=32, backend=backend,
                       args={"x": ConstArray(torch.zeros(32))})
    c = cuda_memcpy_to_symbol(np.arange(4, dtype=np.int32), device="cpu")
    with pytest.raises(UnsupportedSpace):
        c.value = torch.zeros(4)
    np.testing.assert_array_equal(np.asarray(c), np.arange(4))


def test_device_buffer_lifecycle():
    buf = cuda_malloc((32,), torch.int32, device="cpu")
    k = _add_one()
    out = api.launch(k, grid=1, block=32, args={"x": buf})
    assert out["x"] is buf                    # donated handle re-binds
    np.testing.assert_array_equal(cuda_memcpy_d2h(buf), np.ones(32))
    cuda_memcpy_h2d(np.full(32, 7, np.int32), dst=buf)
    assert int(buf.value[0]) == 7
    with pytest.raises(CudaError, match="geometry"):
        cuda_memcpy_h2d(np.zeros(3, np.int32), dst=buf)
    cuda_free(buf)
    with pytest.raises(CudaError, match="use-after-free"):
        api.launch(k, grid=1, block=32, args={"x": buf})
    with pytest.raises(CudaError, match="use-after-free"):
        cuda_memcpy_d2h(buf)
    with pytest.raises(CudaError, match="double free"):
        cuda_free(buf)
    with pytest.raises(CudaError):
        cuda_free(torch.zeros(2))


def test_memory_spaces():
    with pytest.raises(UnsupportedSpace, match="texture"):
        cuda_malloc((4,), space=Space.TEXTURE, device="cpu")
    with pytest.raises(UnsupportedSpace, match="block-scoped"):
        cuda_malloc((4,), space=Space.SHARED, device="cpu")
    assert isinstance(cuda_malloc((4,), space=Space.CONST, device="cpu"),
                      ConstArray)
    h = cuda_memcpy_h2d(np.arange(3, dtype=np.float32), device="cpu")
    assert isinstance(h, DeviceBuffer) and h.value.device.type == "cpu"
    with pytest.raises(TypeError, match="NumPy"):
        api.launch(_add_one(), grid=1, block=32,
                   args={"x": np.zeros(32, np.int32)})


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_malloc((4,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_memcpy_h2d(np.zeros(2, np.float32))


def test_from_reference_carries_the_state_across():
    args = {"a": np.arange(4, dtype=np.int64), "b": np.ones((2, 2)),
            "c": np.zeros(3, np.float32)}
    out = carry.from_reference(args, const=("c",), device="cpu")
    assert out["a"].dtype == torch.int32 and out["b"].dtype == torch.float32
    assert isinstance(out["c"], ConstArray)
    np.testing.assert_array_equal(out["a"].numpy(), args["a"])


def test_fingerprint_covers_the_native_descriptor():
    a = cuda_suite.make_needle_nw(32, 2)
    assert a.fingerprint() == cuda_suite.make_needle_nw(32, 2).fingerprint()
    assert a.fingerprint() != cuda_suite.make_needle_nw(32, 3).fingerprint()
    b = KernelDef("needle_nw", a.stages, writes=a.writes, reads=a.reads,
                  combines=a.combines, donates=a.donates,
                  native=Native.of("needle_nw", n=64, penalty=2))
    assert a.fingerprint() != b.fingerprint()


def test_kernel_declarations_are_validated():
    with pytest.raises(ValueError, match="donates"):
        KernelDef("k", (), writes=("x",), donates=("y",))
    with pytest.raises(ValueError, match="unknown combine"):
        KernelDef("k", (), writes=("x",), combines={"x": "xor"})
    k = KernelDef("k", (), writes=("x",), shared={"s": ((-1,), torch.int32)})
    with pytest.raises(ValueError, match="dyn_shared"):
        k.init_shared(None, "cpu")
    assert k.init_shared(16, "cpu")["s"].shape == (16,)


def test_thread_private_values_keep_the_chunk_axis():
    def bad(ctx, st):
        return st.with_priv({"v": torch.zeros(())})

    k = KernelDef("bad", (bad,), writes=())
    for backend in ("vector", "loop"):
        with pytest.raises(UnsupportedKernel, match="thread-chunk"):
            api.launch(k, grid=1, block=32, args={"x": torch.zeros(1)},
                       backend=backend)


def test_register_demotion_carries_values_across_a_barrier():
    def first(ctx, st):
        return st.with_priv({"v": ctx.tid * 2})

    def second(ctx, st):
        from repro_torch.core import index
        return st.set_glob(y=index.put(st.glob["y"], ctx.tid,
                                       st.priv["v"]))

    k = KernelDef("demote", (first, second), writes=("y",))
    for backend in ("vector", "loop", "loop_nowarp"):
        out = api.launch(k, grid=1, block=64, backend=backend,
                         args={"y": torch.zeros(64, dtype=torch.int32)})
        np.testing.assert_array_equal(out["y"].numpy(), np.arange(64) * 2)
    with pytest.raises(UnsupportedKernel, match="fission"):
        api.launch(k, grid=1, block=64, backend="naive",
                   args={"y": torch.zeros(64, dtype=torch.int32)})


def test_launch_chain_counts_and_stops():
    k = _add_one()
    seen = []

    def prepare(it, bufs):
        seen.append(it)
        return {}

    chain = LaunchChain(steps=(ChainStep(k, 1, 32, prepare=prepare),),
                        repeat=10,
                        stop=lambda b: int(b["x"][0]) >= 3)
    stats = ChainStats()
    out = chain.run(lambda step, b: api.launch(step.kernel, grid=step.grid,
                                               block=step.block, args=b),
                    {"x": torch.zeros(32, dtype=torch.int32)}, stats=stats)
    assert int(out["x"][0]) == 3 and seen == [0, 1, 2]
    assert (stats.iterations, stats.launches, stats.host_syncs) == (3, 3, 3)
    assert stats.syncs_per_iteration == 1.0


def test_run_entry_refuses_chain_modes_not_ported():
    # host, device and graph are the reference's modes; any other raises
    entry = cuda_suite.entry_needle_nw()
    with pytest.raises(ValueError, match="unknown chain_mode"):
        cuda_suite.run_entry(entry, "vector", chain_mode="pipelined",
                             device="cpu")
