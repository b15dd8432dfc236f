"""The port's graph capture, instantiate and replay against the JAX
package's, on the CPU (the cases of ``tests/test_graphs.py``).

Each program runs through both packages on the same inputs: the captured
DAG must have the same nodes, dependencies, levels and summary, a replay
must leave the heap the eager program leaves (bit for bit in the port)
and the reference's replay leaves, and the refusals - host-visible
operations during capture, foreign events, ``update_h2d``'s checks - are
the reference's.  On the CPU a replay walks the nodes over the heap's
tensors in place; the card's ``torch.cuda.CUDAGraph`` path is held by the
``gpu`` tests in ``tests/test_torch_streams_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Runtime as JRuntime
from repro.core import Stream as JStream
from repro.core import cuda_memcpy_async as jmemcpy_async
from repro.core import cuda_suite as jsuite
from repro.core.kernel import KernelDef as JKernelDef
from repro_torch.core import (
    ConstArray,
    Event,
    GraphError,
    KernelDef,
    Runtime,
    Stream,
    api,
    cuda_malloc,
    cuda_memcpy_async,
    cuda_suite,
    index,
)
from repro_torch.core.graphs import write_back
from repro_torch.core.memory import cuda_memcpy_to_symbol

RNG = np.random.default_rng(7)


def make_scale(n, src, dst, scale):
    """dst = scale * src: a minimal declared-reads SPMD kernel (port)."""

    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        val = index.take(st.glob[src], gid.clamp(max=n - 1)) * scale
        idx = cuda_suite._where(gid < n, gid, cuda_suite.OOB)
        return st.set_glob(**{dst: index.put(st.glob[dst], idx, val)})

    return KernelDef(f"scale_{src}_{dst}", (stage,), writes=(dst,),
                     reads=(src, dst))


def jmake_scale(n, src, dst, scale):
    """The same kernel in the reference's IR."""

    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        val = st.glob[src][jnp.minimum(gid, n - 1)] * scale
        idx = jnp.where(gid < n, gid, jsuite.OOB)
        return st.set_glob(
            **{dst: st.glob[dst].at[idx].set(val, mode="drop")})

    return JKernelDef(f"scale_{src}_{dst}", (stage,), writes=(dst,),
                      reads=(src, dst))


def _t(x):
    return torch.from_numpy(np.array(x))


def _zeros(n):
    return np.zeros(n, np.float32)


def _stats(s):
    st = s.stats
    return st.launches, st.syncs, st.barriers_inserted, st.graph_launches


def _same_dag(g, jg):
    assert [(n.kind, n.stream, n.deps, n.label, n.reads, n.writes)
            for n in g.nodes] == \
        [(n.kind, n.stream, n.deps, n.label, n.reads, n.writes)
         for n in jg.nodes]
    assert g.levels() == jg.levels()
    assert g.summary() == jg.summary()


# --- capture / instantiate / replay equivalence ------------------------------
@pytest.mark.parametrize("backend", ["vector", "cuda"])
@pytest.mark.parametrize("name", ["vecadd", "reduce_shared", "softmax_row",
                                  "stencil2d"])
def test_replay_matches_eager_suite_kernel(name, backend):
    """Graph replay is bit-identical to the eager launch path (cuda: the
    kernels' plain versions, since the tensors lie on the CPU), and to the
    reference's replay within the entry's tolerance."""
    te = {e.name: e for e in cuda_suite.build_suite(1)}[name]
    je = {e.name: e for e in jsuite.build_suite(1)}[name]
    args = je.make_args(RNG)
    eager = api.launch(te.kernel, grid=te.grid, block=te.block,
                       args={k: _t(v) for k, v in args.items()},
                       dyn_shared=te.dyn_shared, backend=backend)
    s = Stream({k: _t(v) for k, v in args.items()})
    g = s.begin_capture()
    te.kernel[te.grid, te.block, te.dyn_shared, s].on(backend=backend)()
    s.end_capture()
    g.instantiate(s.buffers).launch(s)
    js = JStream({k: jnp.asarray(v) for k, v in args.items()})
    jg = js.begin_capture()
    je.kernel[je.grid, je.block, je.dyn_shared, js]()
    js.end_capture()
    jg.instantiate(js.buffers).launch(js)
    if backend == "vector":             # a node's label names its backend
        _same_dag(g, jg)
    for w in te.kernel.writes:
        assert torch.equal(s.buffers[w], eager[w]), w
        np.testing.assert_allclose(s.memcpy_d2h(w), js.memcpy_d2h(w),
                                   rtol=te.tol, atol=te.tol)


@pytest.mark.parametrize("backend", ["loop", "vector"])
def test_replay_pipeline_all_backends(backend):
    """A 3-kernel chain replays as the reference's does, bit for bit."""
    n, block = 512, 128
    x = RNG.standard_normal(n).astype(np.float32)
    s = Stream({"b0": _t(x), **{f"b{i}": _t(_zeros(n)) for i in (1, 2, 3)}})
    js = JStream({"b0": jnp.asarray(x),
                  **{f"b{i}": jnp.zeros(n, jnp.float32) for i in (1, 2, 3)}})
    g, jg = s.begin_capture(), js.begin_capture()
    for i in range(3):
        make_scale(n, f"b{i}", f"b{i+1}", 2.0)[
            -(-n // block), block, None, s].on(backend=backend)()
        jmake_scale(n, f"b{i}", f"b{i+1}", 2.0)[
            -(-n // block), block, None, js].on(backend=backend)()
    s.end_capture()
    js.end_capture()
    _same_dag(g, jg)
    assert g.instantiate().inputs == jg.instantiate().inputs
    g.instantiate(s.buffers).launch(s)
    jg.instantiate(js.buffers).launch(js)
    np.testing.assert_array_equal(s.memcpy_d2h("b3"), js.memcpy_d2h("b3"))
    np.testing.assert_array_equal(s.memcpy_d2h("b3"), 8.0 * x)


def test_replay_is_repeatable_and_counts_dispatches():
    n, block = 256, 128
    k = cuda_suite.make_vecadd(n)
    s = Stream({"a": torch.ones(n), "b": torch.ones(n),
                "c": torch.zeros(n)})
    g = s.begin_capture()
    k[2, block, None, s]()
    s.end_capture()
    ex = g.instantiate(s.buffers)
    for _ in range(3):
        ex.launch(s)
    assert s.stats.graph_launches == 3
    assert ex.launches == 3
    np.testing.assert_array_equal(s.memcpy_d2h("c"), 2.0)


def _counter(n=32):
    def stage(ctx, st):
        idx = cuda_suite._where(ctx.tid == 0, 0, cuda_suite.OOB)
        return st.set_glob(cnt=index.put(st.glob["cnt"], idx, 1, op="add"))
    return KernelDef("count", (stage,), writes=("cnt",), reads=("cnt",))


def test_replayed_twice_advances_the_heap_twice():
    # a replay writes the heap's tensors in place: the next replay reads
    # what the last one wrote
    s = Stream({"cnt": torch.zeros(8, dtype=torch.int32)})
    cnt = s.buffers["cnt"]
    g = s.begin_capture()
    s.device_update(lambda h: {"cnt": h["cnt"] * 2})
    _counter()[1, 32, None, s]()
    s.end_capture()
    ex = g.instantiate(s.buffers)
    ex.launch(s)
    ex.launch(s)
    assert s.buffers["cnt"] is cnt
    assert int(cnt[0]) == 3                 # (0 * 2 + 1) * 2 + 1


def test_captured_h2d_and_update():
    """memcpy_h2d captures as a DAG node; update_h2d swaps its source."""
    n, block = 256, 128
    k = cuda_suite.make_vecadd(n)
    s = Stream({"a": torch.zeros(n), "b": torch.ones(n),
                "c": torch.zeros(n)})
    g = s.begin_capture()
    s.memcpy_h2d("a", np.full(n, 3.0, np.float32))
    k[2, block, None, s]()
    s.end_capture()
    assert [nd.kind for nd in g.nodes] == ["h2d", "kernel"]
    ex = g.instantiate(s.buffers)
    ex.launch(s)
    np.testing.assert_array_equal(s.memcpy_d2h("c"), 4.0)
    ex.update_h2d("a", np.full(n, 9.0, np.float32))
    ex.launch(s)
    np.testing.assert_array_equal(s.memcpy_d2h("c"), 10.0)
    with pytest.raises(GraphError):
        ex.update_h2d("nope", np.zeros(n, np.float32))


# --- cross-stream event dependencies ----------------------------------------
@pytest.mark.parametrize("with_event", [False, True])
def test_replay_respects_cross_stream_event_deps(with_event):
    """record/wait_event edges order otherwise-independent streams."""
    n, block = 256, 128
    x0 = RNG.standard_normal(n).astype(np.float32)

    def capture(runtime, scale, arr, zeros):
        rt = runtime({"a": arr(x0), "x": zeros(n), "y": zeros(n)})
        sa, sb = rt.stream("A"), rt.stream("B")
        g = rt.begin_capture()
        scale(n, "a", "x", 2.0)[2, block, None, sa]()
        if with_event:
            ev = rt.event("produced")
            ev.record(sa)
            sb.wait_event(ev)
        scale(n, "a", "y", 3.0)[2, block, None, sb]()
        rt.end_capture()
        g.instantiate(rt.buffers).launch(rt)
        return rt, g

    rt, g = capture(Runtime, make_scale, _t, lambda m: torch.zeros(m))
    jrt, jg = capture(JRuntime, jmake_scale, jnp.asarray,
                      lambda m: jnp.zeros(m, jnp.float32))
    _same_dag(g, jg)
    if with_event:
        assert [nd.kind for nd in g.nodes] == ["kernel", "event_record",
                                               "event_wait", "kernel"]
        assert len(g.levels()) == 4
    else:
        assert len(g.levels()) == 1 and len(g.nodes) == 2
    for name in ("x", "y"):
        np.testing.assert_array_equal(rt.memcpy_d2h(name),
                                      jrt.memcpy_d2h(name))
    assert _stats(rt) == _stats(jrt)


def test_raw_hazard_orders_nodes_across_streams():
    """A RAW hazard (no explicit event) still serializes the DAG."""
    n, block = 256, 128
    rt = Runtime({"a": torch.ones(n), "mid": torch.zeros(n),
                  "out": torch.zeros(n)})
    s0, s1 = rt.stream("s0"), rt.stream("s1")
    g = rt.begin_capture()
    make_scale(n, "a", "mid", 2.0)[2, block, None, s0]()
    make_scale(n, "mid", "out", 5.0)[2, block, None, s1]()
    rt.end_capture()
    assert g.nodes[0].idx in g.nodes[1].deps   # RAW on "mid"
    assert len(g.levels()) == 2
    g.instantiate(rt.buffers).launch(rt)
    np.testing.assert_array_equal(rt.memcpy_d2h("out"), 10.0)


# --- capture rules -----------------------------------------------------------
def test_capture_forbids_host_visible_ops():
    s = Stream({"a": torch.ones(128)})
    s.begin_capture()
    with pytest.raises(GraphError):
        s.memcpy_d2h("a")
    with pytest.raises(GraphError):
        s.synchronize()
    with pytest.raises(GraphError):
        s.malloc("b", (4,), torch.float32)
    with pytest.raises(GraphError):
        s.begin_capture()                     # double capture
    g = s.end_capture()
    with pytest.raises(GraphError):
        s.end_capture()                       # not capturing anymore
    assert g.nodes == []


def test_wait_on_foreign_or_uncaptured_event_raises():
    s = Stream({"a": torch.ones(128)})
    other = Stream({"a": torch.ones(128)})
    foreign = other.begin_capture()
    ev = Event("foreign")
    ev.record(other)
    other.end_capture()
    assert ev._capture[0] is foreign
    s.begin_capture()
    with pytest.raises(GraphError, match="not recorded during this"):
        s.wait_event(Event("never-recorded"))
    with pytest.raises(GraphError, match="not recorded during this"):
        s.wait_event(ev)
    s.end_capture()
    with pytest.raises(GraphError, match="only fires at replay"):
        s.wait_event(ev)                      # eager wait on a captured one
    with pytest.raises(RuntimeError, match="unrecorded"):
        s.wait_event(Event("never"))


def test_instantiate_during_capture_raises():
    s = Stream({"a": torch.ones(8)})
    g = s.begin_capture()
    with pytest.raises(GraphError):
        g.instantiate()
    s.end_capture()


def test_runtime_capture_refuses_half_captured_state():
    """begin_capture must not attach any stream if one is already busy."""
    rt = Runtime({"a": torch.ones(8)})
    sa, sb = rt.stream("A"), rt.stream("B")
    sb.begin_capture()
    with pytest.raises(GraphError, match="already capturing"):
        rt.begin_capture()
    assert sa._capture is None        # A was never attached
    sb.end_capture()
    rt.begin_capture()                # now fine
    rt.end_capture()


def test_update_h2d_validates_shape_dtype_and_ambiguity():
    n = 64
    s = Stream({"a": torch.zeros(n)})
    g = s.begin_capture()
    s.memcpy_h2d("a", np.ones(n, np.float32))
    s.memcpy_h2d("a", np.ones(n, np.float32))
    s.end_capture()
    ex = g.instantiate(s.buffers)
    with pytest.raises(GraphError, match="2 captured h2d nodes"):
        ex.update_h2d("a", np.ones(n, np.float32))
    s2 = Stream({"a": torch.zeros(n)})
    g2 = s2.begin_capture()
    s2.memcpy_h2d("a", np.ones(n, np.float32))
    s2.end_capture()
    ex2 = g2.instantiate(s2.buffers)
    with pytest.raises(GraphError, match="must match"):
        ex2.update_h2d("a", np.ones(n + 1, np.float32))
    with pytest.raises(GraphError, match="must match"):
        ex2.update_h2d("a", np.ones(n, np.int32))
    ex2.update_h2d("a", np.full(n, 5.0, np.float32))
    ex2.launch(s2)
    np.testing.assert_array_equal(s2.memcpy_d2h("a"), 5.0)


# --- Event.elapsed error contract --------------------------------------------
def test_elapsed_raises_before_record():
    e1, e2 = Event("start"), Event("end")
    with pytest.raises(RuntimeError, match="has not been recorded"):
        e1.elapsed(e2)
    s = Stream({"a": torch.ones(8)})
    s.record(e1)
    with pytest.raises(RuntimeError, match="end event"):
        e1.elapsed(e2)
    with pytest.raises(RuntimeError, match="never recorded"):
        e2.synchronize()
    assert not e2.query() and e1.query()


def test_elapsed_raises_for_captured_event():
    e = Event("captured")
    s = Stream({"a": torch.ones(8)})
    s.begin_capture()
    s.record(e)
    s.end_capture()
    with pytest.raises(RuntimeError, match="captured into a graph"):
        e.elapsed(e)


def test_elapsed_happy_path_still_works():
    n, block = 256, 128
    k = cuda_suite.make_vecadd(n)
    s = Stream({"a": torch.ones(n), "b": torch.ones(n),
                "c": torch.zeros(n)})
    e1 = s.record()
    k[2, block, None, s]()
    e2 = s.record()
    assert e1.elapsed(e2) >= 0.0


# --- memcpy nodes: d2d capture + async copy ordering -------------------------
def test_captured_d2d_replays_identically_to_eager():
    """A graph holding [h2d, d2d, kernel] nodes replays bit-identically
    to the same eager sequence, and to the reference's."""
    n, block = 256, 128
    x = np.arange(n, dtype=np.float32)

    def pipeline(s, scale, copy):
        copy("a", x, stream=s)                     # h2d node
        copy("b", "a", stream=s)                   # d2d node
        scale(n, "b", "c", 2.0)[2, block, None, s]()

    def heap():
        return {k: torch.zeros(n) for k in "abc"}

    eager = Stream(heap())
    pipeline(eager, make_scale, cuda_memcpy_async)
    captured = Stream(heap())
    g = captured.begin_capture()
    pipeline(captured, make_scale, cuda_memcpy_async)
    captured.end_capture()
    js = JStream({k: jnp.zeros(n, jnp.float32) for k in "abc"})
    jg = js.begin_capture()
    pipeline(js, jmake_scale, jmemcpy_async)
    js.end_capture()
    _same_dag(g, jg)
    assert [nd.kind for nd in g.nodes] == ["h2d", "d2d", "kernel"]
    g.instantiate(captured.buffers).launch(captured)
    jg.instantiate(js.buffers).launch(js)
    for name in "abc":
        np.testing.assert_array_equal(captured.memcpy_d2h(name),
                                      eager.memcpy_d2h(name))
        np.testing.assert_array_equal(captured.memcpy_d2h(name),
                                      js.memcpy_d2h(name))
    assert _stats(captured) == _stats(js)


def test_captured_update_node_replays_identically():
    """Stream.device_update captures as an update node."""
    n, block = 256, 128
    k = make_scale(n, "a", "b", 3.0)
    bump = lambda h: {"a": h["a"] + 1.0}        # noqa: E731

    eager = Stream({"a": torch.ones(n), "b": torch.zeros(n)})
    eager.device_update(bump)
    k[2, block, None, eager]()
    captured = Stream({"a": torch.ones(n), "b": torch.zeros(n)})
    g = captured.begin_capture()
    assert captured.device_update(bump) == ("a",)
    k[2, block, None, captured]()
    captured.end_capture()
    assert [nd.kind for nd in g.nodes] == ["update", "kernel"]
    assert g.nodes[0].idx in g.nodes[1].deps     # RAW on "a"
    g.instantiate(captured.buffers).launch(captured)
    np.testing.assert_array_equal(captured.memcpy_d2h("b"),
                                  eager.memcpy_d2h("b"))
    np.testing.assert_array_equal(captured.memcpy_d2h("b"), 6.0)


@pytest.mark.parametrize("order", ["src_first", "dst_first"])
@pytest.mark.parametrize("captured", [False, True])
def test_ping_pong_update_never_clobbers_itself(order, captured):
    # {"src": dst, "dst": zeros} written in place: src must get dst's old
    # values whichever the dict's order, eagerly and on replay
    def swap(h):
        upd = {"src": h["dst"], "dst": torch.zeros_like(h["dst"])}
        return upd if order == "src_first" else dict(reversed(upd.items()))

    s = Stream({"src": torch.arange(4.0), "dst": torch.arange(4.0) + 10})
    src, dst = s.buffers["src"], s.buffers["dst"]
    if captured:
        g = s.begin_capture()
        s.device_update(swap)
        s.end_capture()
        g.instantiate(s.buffers).launch(s)
    else:
        s.device_update(swap)
    assert s.buffers["src"] is src and s.buffers["dst"] is dst
    assert src.tolist() == [10.0, 11.0, 12.0, 13.0]
    assert dst.tolist() == [0.0] * 4


def test_write_back_keeps_each_buffers_geometry():
    heap = {"a": torch.zeros(4)}
    with pytest.raises(GraphError, match="in place"):
        write_back(heap, {"a": torch.zeros(5)})
    with pytest.raises(GraphError, match="in place"):
        write_back(heap, {"a": torch.zeros(4, dtype=torch.int32)})
    write_back(heap, {"b": torch.ones(2)})      # a new buffer joins
    assert heap["b"].tolist() == [1.0, 1.0]


def test_memcpy_async_observes_event_wait():
    """cudaMemcpyAsync on a stream that waited on an event orders after
    the fenced producer (cudaStreamWaitEvent -> copy)."""
    n, block = 256, 128
    rt = Runtime({"a": torch.ones(n), "x": torch.zeros(n),
                  "y": torch.zeros(n)})
    s0, s1 = rt.stream("compute"), rt.stream("copy")
    make_scale(n, "a", "x", 2.0)[2, block, None, s0]()
    ev = rt.event("produced")
    ev.record(s0)
    s1.wait_event(ev)
    assert s1.stats.barriers_inserted == 1       # x was pending on s0
    cuda_memcpy_async("y", "x", stream=s1)       # must see s0's write
    np.testing.assert_array_equal(s1.memcpy_d2h("y"), 2.0)


def test_memcpy_async_cross_stream_hazard_barrier():
    """A named d2d whose source has an in-flight foreign writer inserts
    the implicit barrier (Listing 4, stream-to-stream) - no event needed."""
    n, block = 256, 128
    rt = Runtime({"a": torch.ones(n), "x": torch.zeros(n),
                  "y": torch.zeros(n)})
    s0, s1 = rt.stream("s0"), rt.stream("s1")
    make_scale(n, "a", "x", 5.0)[2, block, None, s0]()
    assert "x" in s0._pending
    before = s1.stats.barriers_inserted
    cuda_memcpy_async("y", "x", stream=s1)
    assert s1.stats.barriers_inserted == before + 1
    np.testing.assert_array_equal(s1.memcpy_d2h("y"), 5.0)


def test_raw_handle_copy_rejected_during_capture():
    a = cuda_malloc((8,), torch.float32, device="cpu")
    s = Stream({"x": torch.zeros(8)})
    s.begin_capture()
    with pytest.raises(GraphError, match="named heap buffer"):
        cuda_memcpy_async(a, np.ones(8, np.float32), stream=s)
    s.end_capture()


def test_captured_d2d_unknown_source_raises():
    s = Stream({"x": torch.zeros(8)})
    s.begin_capture()
    with pytest.raises(GraphError, match="d2d source"):
        s.memcpy_d2d("x", "ghost")
    s.end_capture()


def test_const_heap_buffer_replays_through_graph():
    """ConstArray heap entries unwrap at replay time (bfs's edges case)."""
    n, block = 256, 128
    k = make_scale(n, "a", "b", 2.0)
    s = Stream({"a": cuda_memcpy_to_symbol(np.ones(n, np.float32),
                                           device="cpu"),
                "b": torch.zeros(n)})
    g = s.begin_capture()
    k[2, block, None, s]()
    s.end_capture()
    g.instantiate(s.buffers).launch(s)
    assert isinstance(s.buffers["a"], ConstArray)
    np.testing.assert_array_equal(s.memcpy_d2h("b"), 2.0)


def test_replay_needs_its_inputs_on_the_heap():
    s = Stream({"a": torch.ones(8), "b": torch.zeros(8)})
    g = s.begin_capture()
    make_scale(8, "a", "b", 2.0)[1, 8, None, s]()
    s.end_capture()
    ex = g.instantiate()
    with pytest.raises(GraphError, match="needs buffer"):
        ex.replay({"b": torch.zeros(8)})
    with pytest.raises(GraphError, match="capturing"):
        s.begin_capture()
        try:
            ex.launch(s)
        finally:
            s.end_capture()
