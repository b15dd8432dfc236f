"""The port's streams, events and runtime against the JAX package's, on
the CPU.

A scripted two-stream program - launches on two streams of one
``Runtime``, an event recorded on one and waited on by the other, a
cross-stream RAW hazard with no event, default-stream copies and a
device-to-host read - runs through both packages under both policies:
each stream's ``StreamStats`` (launches, syncs, inserted barriers, graph
launches: the paper's Fig. 11 quantities) and every buffer, bit for bit,
must be the reference's.  The rest holds the stream surface: the chevron's
stream slot, handle re-binding, ``device_update``, ``malloc`` and the
refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Policy as JPolicy  # noqa: E402
from repro.core import Runtime as JRuntime  # noqa: E402
from repro.core import Stream as JStream  # noqa: E402
from repro.core import cuda_memcpy_h2d as jmemcpy_h2d  # noqa: E402
from repro.core import cuda_suite as jsuite  # noqa: E402
from repro.core.kernel import KernelDef as JKernelDef  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DeviceBuffer,
    KernelDef,
    Policy,
    Runtime,
    Stream,
    cuda_memcpy_h2d,
    cuda_suite,
    index,
)
from repro_torch.core.memory import UnsupportedSpace, cuda_memcpy_to_symbol  # noqa: E402
from repro_torch.core.streams import heap_device  # noqa: E402

N, BLOCK = 256, 128


def _scale(n, src, dst, scale):
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        val = index.take(st.glob[src], gid.clamp(max=n - 1)) * scale
        idx = cuda_suite._where(gid < n, gid, cuda_suite.OOB)
        return st.set_glob(**{dst: index.put(st.glob[dst], idx, val)})
    return KernelDef(f"scale_{src}_{dst}", (stage,), writes=(dst,),
                     reads=(src, dst))


def _jscale(n, src, dst, scale):
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        val = st.glob[src][jnp.minimum(gid, n - 1)] * scale
        idx = jnp.where(gid < n, gid, jsuite.OOB)
        return st.set_glob(
            **{dst: st.glob[dst].at[idx].set(val, mode="drop")})
    return JKernelDef(f"scale_{src}_{dst}", (stage,), writes=(dst,),
                      reads=(src, dst))


PORT = dict(runtime=Runtime, policy=Policy, scale=_scale,
            arr=lambda x: torch.from_numpy(x.copy()))
REF = dict(runtime=JRuntime, policy=JPolicy, scale=_jscale, arr=jnp.asarray)


def _two_streams(pkg, policy: str):
    """The scripted program; returns the runtime and what it read back."""
    x = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    zeros = np.zeros(N, np.float32)
    rt = pkg["runtime"]({"a": pkg["arr"](x), "x": pkg["arr"](zeros),
                         "y": pkg["arr"](zeros), "z": pkg["arr"](zeros)},
                        pkg["policy"][policy])
    s0, s1 = rt.stream("compute"), rt.stream("copy")
    scale = pkg["scale"]
    scale(N, "a", "x", 2.0)[2, BLOCK, None, s0]()    # s0 writes x
    ev = rt.event("produced")
    ev.record(s0)                                    # fences x
    scale(N, "a", "y", 3.0)[2, BLOCK, None, s0]()    # after the record
    s1.wait_event(ev)                                # x pending: a barrier
    scale(N, "x", "z", 5.0)[2, BLOCK, None, s1]()    # RAW on x, fenced
    scale(N, "y", "z", 7.0)[2, BLOCK, None, s1]()    # RAW on y: no event
    rt.memcpy_h2d("a", np.full(N, 4.0, np.float32))  # default stream
    rt.memcpy_d2d("x", "z")                          # z pending on s1
    scale(N, "a", "y", 0.5)[2, BLOCK, None, s1]()
    read = s0.memcpy_d2h("y")                        # y pending on s1
    ev2 = s1.record()
    s0.wait_event(ev2)                               # nothing left pending
    rt.synchronize()
    return rt, read


def _stats(rt):
    return {s.name: (s.stats.launches, s.stats.syncs,
                     s.stats.barriers_inserted, s.stats.graph_launches)
            for s in rt.streams}


@pytest.mark.parametrize("policy", ["HAZARD_ONLY", "SYNC_ALWAYS"])
def test_two_stream_program_counts_and_computes_as_the_reference(policy):
    rt, read = _two_streams(PORT, policy)
    jrt, jread = _two_streams(REF, policy)
    assert _stats(rt) == _stats(jrt)
    assert set(rt.buffers) == set(jrt.buffers)
    for name in rt.buffers:
        np.testing.assert_array_equal(rt.memcpy_d2h(name),
                                      jrt.memcpy_d2h(name), err_msg=name)
    np.testing.assert_array_equal(read, jread)
    total, jtotal = rt.stats, jrt.stats
    assert (total.launches, total.syncs, total.barriers_inserted) == \
        (jtotal.launches, jtotal.syncs, jtotal.barriers_inserted)


def test_sync_always_syncs_more_than_hazard_only():
    # the paper's Fig. 11 contrast: HIP-CPU's sync after every launch
    # against CuPBoP's barrier at hazards only
    hazard, _ = _two_streams(PORT, "HAZARD_ONLY")
    always, _ = _two_streams(PORT, "SYNC_ALWAYS")
    assert always.stats.launches == hazard.stats.launches == 5
    assert always.stats.syncs > hazard.stats.syncs


@pytest.mark.parametrize("policy", ["HAZARD_ONLY", "SYNC_ALWAYS"])
def test_single_stream_launch_loop_counts_as_the_reference(policy):
    def run(stream_t, pol, scale, arr):
        s = stream_t({"a": arr(np.ones(N, np.float32)),
                      "b": arr(np.zeros(N, np.float32))}, pol[policy])
        for i in range(6):
            src, dst = ("a", "b") if i % 2 == 0 else ("b", "a")
            scale(N, src, dst, 1.5)[2, BLOCK, None, s]()
            if i % 3 == 2:
                s.memcpy_h2d("a", np.full(N, i, np.float32))
        s.synchronize()
        s.synchronize()                     # nothing pending: no sync
        st = s.stats
        return (st.launches, st.syncs, st.barriers_inserted), \
            s.memcpy_d2h("a"), s.memcpy_d2h("b")

    got = run(Stream, Policy, _scale, lambda x: torch.from_numpy(x.copy()))
    want = run(JStream, JPolicy, _jscale, jnp.asarray)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _add_one(pkg):
    if pkg == "port":
        def stage(ctx, st):
            gid = ctx.bid * ctx.block_dim + ctx.tid
            x = st.glob["x"]
            return st.set_glob(x=index.put(x, gid, index.take(x, gid) + 1))
        return KernelDef("add_one", (stage,), writes=("x",), reads=("x",),
                         donates=("x",))

    def jstage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        x = st.glob["x"]
        return st.set_glob(x=x.at[gid].set(x[gid] + 1))
    return JKernelDef("add_one", (jstage,), writes=("x",), reads=("x",),
                      donates=("x",))


def test_chevron_stream_slot_launches_on_the_stream_and_rebinds_handles():
    s = Stream({"x": torch.zeros(32, dtype=torch.int32)})
    x = s.buffers["x"]
    h = cuda_memcpy_h2d(np.arange(32, dtype=np.int32), device="cpu")
    assert _add_one("port")[1, 32, None, s](x=h) is s
    assert s.buffers["x"] is x                 # written in place
    assert isinstance(h, DeviceBuffer) and h.value is x
    assert s.stats.launches == 1 and "x" in s._pending
    js = JStream({"x": jnp.zeros(32, jnp.int32)})
    jh = jmemcpy_h2d(np.arange(32, dtype=np.int32))
    assert _add_one("ref")[1, 32, None, js](x=jh) is js
    np.testing.assert_array_equal(x.numpy(), np.asarray(js.buffers["x"]))
    np.testing.assert_array_equal(np.asarray(h), np.asarray(jh))
    with pytest.raises(KeyError, match="no buffer"):
        _add_one("port")[1, 32, None, s](y=torch.zeros(32))


def test_device_update_infers_writes_and_marks_pending():
    s = Stream({"a": torch.zeros(8), "b": torch.ones(8)})
    a = s.buffers["a"]
    written = s.device_update(lambda h: {"a": h["b"] + 1})
    assert written == ("a",)
    assert "a" in s._pending and s.buffers["a"] is a
    np.testing.assert_array_equal(s.memcpy_d2h("a"), 2.0)
    rt = Runtime({"a": torch.zeros(8)})
    assert rt.device_update(lambda h: {"a": h["a"] - 1}, ("a",)) == ("a",)
    np.testing.assert_array_equal(rt.memcpy_d2h("a"), -1.0)


def test_malloc_and_copies_onto_the_named_heap():
    rt = Runtime({"a": torch.zeros(4)})
    rt.malloc("m", (2, 3), np.float64)         # narrowed, as jnp.zeros
    assert rt.buffers["m"].dtype == torch.float32
    assert rt.buffers["m"].shape == (2, 3)
    rt.memcpy_h2d("fresh", np.arange(3, dtype=np.int32))
    np.testing.assert_array_equal(rt.memcpy_d2h("fresh"), [0, 1, 2])
    rt.memcpy_d2d("copy", "fresh")
    assert rt.buffers["copy"] is not rt.buffers["fresh"]
    np.testing.assert_array_equal(rt.memcpy_d2h("copy"), [0, 1, 2])
    with pytest.raises(KeyError, match="no source buffer"):
        rt.memcpy_d2d("copy", "ghost")
    with pytest.raises(Exception, match="geometry mismatch"):
        rt.memcpy_d2d("a", "fresh")


def test_constant_heap_buffers_refuse_every_write():
    s = Stream({"c": cuda_memcpy_to_symbol(np.ones(4, np.float32),
                                           device="cpu"),
                "x": torch.zeros(4)})
    with pytest.raises(UnsupportedSpace):
        s.memcpy_h2d("c", np.zeros(4, np.float32))
    with pytest.raises(UnsupportedSpace):
        s.memcpy_d2d("c", "x")
    with pytest.raises(UnsupportedSpace):
        s.device_update(lambda h: {"c": h["x"]})


def test_events_on_the_cpu_stamp_the_host_clock():
    s = Stream({"a": torch.ones(8)})
    e1 = s.record()
    e2 = s.record()
    assert e1.query() and e2.query()
    assert e1.synchronize() is e1
    assert e1.elapsed(e2) >= 0.0
    s.wait_event(e1)                    # same stream: nothing to do
    assert s.stats.barriers_inserted == 0


def test_a_heap_lies_on_one_device_and_the_card_is_the_default():
    with pytest.raises(ValueError, match="several devices"):
        heap_device({"a": torch.zeros(2), "b": torch.zeros(2,
                                                           device="meta")})
    with pytest.raises(TypeError, match="torch tensors"):
        Stream({"a": np.zeros(2)})
    with pytest.raises(ValueError, match="not on"):
        Stream({"a": torch.zeros(2)}, device="meta")
    assert Stream(device="cpu").device.type == "cpu"
    assert Stream({"a": torch.zeros(2)}).device.type == "cpu"
    if not torch.cuda.is_available():       # no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Stream()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Runtime()
