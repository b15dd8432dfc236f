"""Streams, events, CUDA graphs and device-resident chains on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; on a
machine with one they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_streams_gpu.py``.  The file imports neither JAX nor the
reference package, so it collects where they are absent; the CPU tests
that hold the same code against the reference are
``tests/test_torch_streams.py``, ``tests/test_torch_graphs.py`` and
``tests/test_torch_device_resident.py``.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import (  # noqa: E402
    KernelDef,
    Runtime,
    Stream,
    cuda_malloc,
    cuda_memcpy_async,
    cuda_suite,
    index,
    lower_cuda,
)
from repro_torch.core.kernel import ChainStats  # noqa: E402

CHAINS = ("bfs_frontier", "pathfinder", "needle_nw", "hotspot",
          "srad_step", "nn", "kmeans")
#: medium sizes, well past the suite's: many CTAs, long chains
MEDIUM = {"bfs_frontier": {"n": 1 << 16, "deg": 6},
          "pathfinder": {"cols": 1 << 16, "rows": 40},
          "needle_nw": {"n": 256},
          "hotspot": {"h": 256, "w": 256, "iters": 9},
          "srad_step": {"h": 256, "w": 512, "iters": 5},
          "nn": {"n": 1 << 14, "block": 128, "knn": 7},
          "kmeans": {"n": 1 << 14, "k": 4, "block": 64, "repeat": 12}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _host(out):
    return {k: (v.value if hasattr(v, "value") else v).cpu()
            for k, v in out.items()}


def _run(entry, args, card, mode, **kw):
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0
    stats = ChainStats()
    out, _ = cuda_suite.run_entry(entry, "cuda", args=args, device=card,
                                  chain_mode=mode, chain_stats=stats,
                                  with_reference=False, **kw)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in lower_cuda.KERNELS.values()
              if k.launches}
    return _host(out), stats, counts


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("device", "graph"))
@pytest.mark.parametrize("size", ("suite", "medium"))
@pytest.mark.parametrize("name", CHAINS)
def test_chain_mode_bit_for_bit_with_host_mode_on_the_card(card, name, size,
                                                           mode):
    entry = (getattr(cuda_suite, f"entry_{name}")(**MEDIUM[name])
             if size == "medium"
             else {e.name: e for e in cuda_suite.build_suite(1)}[name])
    args = entry.make_args(np.random.default_rng(42))
    host, hstats, _ = _run(entry, args, card, "host")
    out, stats, counts = _run(entry, args, card, mode)
    for k, v in host.items():
        if k not in entry.iteration_state:
            assert torch.equal(out[k], v), k
    # every device launch counted once: graph replays add the captured
    # kernels' counts, the capture itself counts nothing
    assert sum(counts.values()) == stats.launches
    assert set(counts) == {s.kernel.name for s in entry.chain.steps}
    if mode == "graph" and entry.chain.repeat > 1:
        assert stats.graph_replays >= 1
    if entry.chain.device_stop is not None:
        assert stats.host_syncs < hstats.host_syncs


@pytest.mark.gpu
def test_graph_exec_replayed_twice_advances_the_heap_twice(card):
    entry = cuda_suite.entry_needle_nw(n=128)
    args = entry.make_args(np.random.default_rng(1))
    stream = Stream(carry.from_reference(args, device=card))
    step = entry.chain.steps[0]
    stream.launch(step.kernel, grid=step.grid, block=step.block,
                  backend="cuda")
    ex = entry.chain.capture_unit(stream, 20, backend="cuda")
    score = stream.buffers["score"]
    before = lower_cuda.KERNELS["needle_nw"].launches
    ex.launch(stream)
    ex.launch(stream)
    torch.cuda.synchronize()
    assert lower_cuda.KERNELS["needle_nw"].launches == before + 40
    assert stream.buffers["score"] is score
    assert int(stream.buffers["diag"][0]) == 2 + 40
    want = cuda_suite.nw_scores(args["score"], args["sim"], 2)
    got = score.cpu().numpy()
    i, j = np.indices(got.shape)
    done = (i + j <= 42) & (i > 0) & (j > 0)     # anti-diagonals 2 .. 42
    np.testing.assert_array_equal(got[done], want[done])
    assert (got[(i + j > 42) & (i > 0) & (j > 0)] == 0).all()


@pytest.mark.gpu
def test_bfs_scratch_survives_capture(card):
    # the capture allocates each stream's owner array outside the graph,
    # and every replayed launch puts it back to INT_MAX
    entry = cuda_suite.entry_bfs_frontier(n=1 << 14, deg=6)
    args = entry.make_args(np.random.default_rng(2))
    host, _, _ = _run(entry, args, card, "host")
    for _ in range(2):
        out, stats, _ = _run(entry, args, card, "graph")
        assert torch.equal(out["dist"], host["dist"])
        assert stats.graph_replays >= 2
    owners = [s["owner"] for s in lower_cuda._BFS_SCRATCH.values()
              if s["owner"].device.type == "cuda"]
    assert len(owners) >= 2          # the eager stream's and a capture's
    for owner in owners:
        assert bool((owner == lower_cuda._INT_MAX).all())


@pytest.mark.gpu
def test_srad_dependent_launch_inside_a_capture(card):
    # srad_update's stencil is its fold's programmatic dependent launch
    entry = cuda_suite.entry_srad_step(h=512, w=512, iters=6)
    args = entry.make_args(np.random.default_rng(3))
    host, _, _ = _run(entry, args, card, "host")
    out, stats, counts = _run(entry, args, card, "graph")
    assert stats.graph_replays == 1
    assert counts == {"srad_stats": 6, "srad_update": 6}
    for k in ("x", "y", "psum", "psq"):
        assert torch.equal(out[k], host[k]), k


@pytest.mark.gpu
def test_event_elapsed_across_a_replay(card):
    entry = cuda_suite.entry_hotspot(h=512, w=512, iters=11)
    args = entry.make_args(np.random.default_rng(4))
    stream = Stream(carry.from_reference(args, const=entry.const,
                                         device=card))
    step = entry.chain.steps[0]
    stream.launch(step.kernel, grid=step.grid, block=step.block,
                  backend="cuda")
    ex = entry.chain.capture_unit(stream, 10, backend="cuda")
    start = stream.record()
    ex.launch(stream)
    end = stream.record()
    ms = start.elapsed(end)
    assert 0.0 < ms < 1000.0
    assert end.query()


@pytest.mark.gpu
def test_memcpy_async_h2d_returns_before_the_copy(card):
    # the stream is held busy by a spin; a staged, non-blocking h2d
    # returns at once, and lands after the spin
    n = 1 << 24
    host = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    dst = cuda_malloc((n,), torch.float32, device=card)
    rt = Runtime({"x": torch.zeros(n, device=card)})
    s = rt.stream("copy")
    with torch.cuda.stream(s.cuda_stream):
        torch.cuda._sleep(2_000_000_000)          # about a second
    t0 = time.perf_counter()
    cuda_memcpy_async(dst, host, stream=s)
    cuda_memcpy_async("x", host, stream=s)
    issued = time.perf_counter() - t0
    done = s.record()
    assert not done.query()
    assert issued < 0.2
    s.synchronize()
    assert done.query()
    np.testing.assert_array_equal(dst.value.cpu().numpy(), host)
    np.testing.assert_array_equal(s.memcpy_d2h("x"), host)


def _scale(n, src, dst, scale):
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        val = index.take(st.glob[src], gid.clamp(max=n - 1)) * scale
        idx = cuda_suite._where(gid < n, gid, cuda_suite.OOB)
        return st.set_glob(**{dst: index.put(st.glob[dst], idx, val)})
    return KernelDef(f"scale_{src}_{dst}", (stage,), writes=(dst,),
                     reads=(src, dst))


def _two_streams(device):
    n = 1 << 16
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(n)
                         .astype(np.float32))
    rt = Runtime({"a": x.to(device), **{k: torch.zeros(n, device=device)
                                        for k in ("x", "y", "z")}})
    s0, s1 = rt.stream("compute"), rt.stream("copy")
    g = n // 256
    _scale(n, "a", "x", 2.0)[g, 256, None, s0]()
    ev = rt.event()
    ev.record(s0)
    _scale(n, "a", "y", 3.0)[g, 256, None, s0]()
    s1.wait_event(ev)
    _scale(n, "x", "z", 5.0)[g, 256, None, s1]()
    _scale(n, "y", "z", 7.0)[g, 256, None, s1]()
    rt.memcpy_h2d("a", np.full(n, 4.0, np.float32))
    rt.memcpy_d2d("x", "z")
    _scale(n, "a", "y", 0.5)[g, 256, None, s1]()
    rt.synchronize()
    return ({s.name: (s.stats.launches, s.stats.syncs,
                      s.stats.barriers_inserted) for s in rt.streams},
            {k: rt.memcpy_d2h(k) for k in rt.buffers})


@pytest.mark.gpu
def test_two_streams_on_the_card_count_and_compute_as_on_the_cpu(card):
    stats, bufs = _two_streams(card)
    cpu_stats, cpu_bufs = _two_streams("cpu")
    assert stats == cpu_stats
    for k, v in cpu_bufs.items():
        np.testing.assert_array_equal(bufs[k], v, err_msg=k)


@pytest.mark.gpu
def test_captured_copies_update_h2d_and_another_heap_on_the_card(card):
    # h2d from page-locked staging, d2d and a kernel in one CUDA graph;
    # update_h2d rewrites the staged source; a replay over another heap
    # of the same geometry copies its values into the captured tensors
    n = 1 << 16
    kern = cuda_suite.make_vecadd(n)

    def heap():
        return {k: torch.zeros(n, device=card) for k in "abc"}

    s = Stream(heap())
    x = np.arange(n, dtype=np.float32)
    g = s.begin_capture()
    s.memcpy_h2d("a", x)
    cuda_memcpy_async("b", "a", stream=s)
    kern[n // 128, 128, None, s].on(backend="cuda")()
    s.end_capture()
    assert [nd.kind for nd in g.nodes] == ["h2d", "d2d", "kernel"]
    ex = g.instantiate(s.buffers)
    before = lower_cuda.KERNELS["vecadd"].launches
    ex.launch(s)
    np.testing.assert_array_equal(s.memcpy_d2h("c"), 2 * x)
    ex.update_h2d("a", 3 * x)
    ex.launch(s)
    np.testing.assert_array_equal(s.memcpy_d2h("c"), 6 * x)
    assert lower_cuda.KERNELS["vecadd"].launches == before + 2
    other = Stream(heap())
    ex.launch(other)
    np.testing.assert_array_equal(other.memcpy_d2h("c"), 6 * x)
    with pytest.raises(Exception, match="re-capture"):
        ex.launch(Stream({k: torch.zeros(n + 1, device=card)
                          for k in "abc"}))


def _captured_two_streams(device):
    # the cuda backend's kernels (their plain versions on the CPU) and
    # update nodes: the IR lowerings' stages copy host scalars to the
    # card, which a CUDA graph capture refuses
    n = 1 << 16
    rng = np.random.default_rng(7)
    rt = Runtime({k: torch.from_numpy(rng.standard_normal(n)
                                      .astype(np.float32)).to(device)
                  for k in ("a", "b", "c", "z")})
    sa, sb = rt.stream("A"), rt.stream("B")
    g = rt.begin_capture()
    cuda_suite.make_vecadd(n)[n // 128, 128, None, sa].on(backend="cuda")()
    ev = rt.event("produced")
    ev.record(sa)
    sb.wait_event(ev)
    sb.device_update(lambda h: {"z": h["c"] * 2})
    rt.device_update(lambda h: {"a": h["z"] - h["b"]})
    rt.end_capture()
    ex = g.instantiate(rt.buffers)
    for _ in range(2):
        ex.launch(rt)
    rt.synchronize()
    return [n.kind for n in g.nodes], g.levels(), \
        {k: rt.memcpy_d2h(k) for k in rt.buffers}


@pytest.mark.gpu
def test_a_runtime_capture_over_two_streams_replays_as_on_the_cpu(card):
    kinds, levels, bufs = _captured_two_streams(card)
    cpu_kinds, cpu_levels, cpu_bufs = _captured_two_streams("cpu")
    assert kinds == cpu_kinds == ["kernel", "event_record", "event_wait",
                                  "update", "update"]
    assert levels == cpu_levels
    for k, v in cpu_bufs.items():
        np.testing.assert_array_equal(bufs[k], v, err_msg=k)


@pytest.mark.gpu
def test_a_capture_the_card_refuses_raises_and_runs_nothing(card):
    # the vector lowering's stages copy host scalars to the card, which a
    # CUDA graph capture refuses: the error surfaces, nothing falls back
    # to an eager replay, and the heap is left as it was
    n = 256
    s = Stream({"a": torch.ones(n, device=card),
                "x": torch.zeros(n, device=card)})
    g = s.begin_capture()
    _scale(n, "a", "x", 2.0)[2, 128, None, s]()
    s.end_capture()
    with pytest.raises(RuntimeError):
        g.instantiate(s.buffers)
    torch.cuda.synchronize()
    assert torch.equal(s.buffers["x"], torch.zeros(n, device=card))
