"""The port's kernel-serving tier on the CPU: every contract of the
reference's ``tests/test_serve.py``.

* a stacked-batch dispatch is bit for bit the N independent launches it
  replaces, on ``loop``, ``vector`` and ``cuda`` (its plain versions over
  CPU tensors);
* backpressure (bounded queue) and per-request timeouts fail loudly with
  typed errors instead of stalling the worker;
* a faulting tenant (const-space violation, freed handle) takes down only
  its own request - co-batched and subsequent requests keep serving;
* the stats counters add up: submitted = completed + failed + timed_out
  (+ still pending), occupancy histogram sums to dispatches.

The test kernel is the suite's vecadd (``cuda_suite.make_vecadd``), which
every backend runs.  The batch entry on the card is held to the same
contract in ``tests/test_torch_serve_gpu.py``.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import api, backends, cuda_suite, memory  # noqa: E402
from repro_torch.core.kernel import UnsupportedKernel  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    KernelService,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    ServiceTimeout,
)

N = 256
BLOCK = 64
GRID = N // BLOCK
BACKENDS = ("loop", "vector", "cuda")


def vecadd_args(rng, n=N):
    return {"a": torch.from_numpy(rng.standard_normal(n, dtype=np.float32)),
            "b": torch.from_numpy(rng.standard_normal(n, dtype=np.float32)),
            "c": torch.zeros(n, dtype=torch.float32)}


@pytest.fixture
def kernel():
    return cuda_suite.make_vecadd(N)


def _bits(x):
    return memory.unwrap(x).numpy().tobytes()


def _service(backend, **kw):
    return KernelService(backend=backend, device="cpu", **kw)


# -------------------------------------------------------------------------
# launch_batch: the stacked-dispatch primitive
# -------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["vecadd", "softmax_row", "reduce_shared"])
def test_launch_batch_bit_identical_to_independent(name, backend):
    entry = next(e for e in cuda_suite.build_suite(scale=1) if e.name == name)
    rng = np.random.default_rng(0)
    args_list = [carry.from_reference(entry.make_args(rng), device="cpu")
                 for _ in range(4)]
    solo = [api.launch(entry.kernel, grid=entry.grid, block=entry.block,
                       args=a, dyn_shared=entry.dyn_shared, backend=backend)
            for a in args_list]
    batched = api.launch_batch(entry.kernel, grid=entry.grid,
                               block=entry.block, args_list=args_list,
                               dyn_shared=entry.dyn_shared, backend=backend)
    for s, b in zip(solo, batched):
        for k in entry.kernel.writes:
            assert s[k].dtype == b[k].dtype
            assert _bits(s[k]) == _bits(b[k]), (name, backend, k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_launch_batch_shares_cache_stats(kernel, backend):
    api.cache_clear()
    rng = np.random.default_rng(1)
    args_list = [vecadd_args(rng) for _ in range(3)]
    api.launch_batch(kernel, grid=GRID, block=BLOCK, args_list=args_list,
                     backend=backend)
    s0 = api.cache_stats()
    assert (s0.hits, s0.misses) == (0, 1)
    api.launch_batch(kernel, grid=GRID, block=BLOCK, args_list=args_list,
                     backend=backend)
    s1 = api.cache_stats()
    assert (s1.hits, s1.misses) == (s0.hits + 1, s0.misses)
    # a batch of one is a plain launch: the plain launch's own entry
    api.launch_batch(kernel, grid=GRID, block=BLOCK,
                     args_list=args_list[:1], backend=backend)
    assert api.cache_size() == 2
    api.cache_clear()


def test_launch_batch_rejects_incompatible_shapes(kernel):
    rng = np.random.default_rng(2)
    good = vecadd_args(rng)
    bad = {"a": torch.zeros(N // 2), "b": torch.zeros(N // 2),
           "c": torch.zeros(N // 2)}
    with pytest.raises(ValueError, match="request 1"):
        api.launch_batch(kernel, grid=GRID, block=BLOCK,
                         args_list=[good, bad], backend="loop")
    other_dtype = {**good, "c": torch.zeros(N, dtype=torch.float64)}
    with pytest.raises(ValueError, match="request 1"):
        api.launch_batch(kernel, grid=GRID, block=BLOCK,
                         args_list=[good, other_dtype], backend="loop")


def test_launch_batch_rejects_empty_and_multi_device(kernel):
    with pytest.raises(ValueError, match="non-empty"):
        api.launch_batch(kernel, grid=GRID, block=BLOCK, args_list=[])
    rng = np.random.default_rng(3)
    # the shard backends are refused as the reference refuses ``shard``,
    # and so is any backend that says it shards
    vector = backends.get_backend("vector")
    backends.register_backend("sharded_probe", vector.run,
                              {"multi_device"})
    try:
        for backend in ("shard", "shard_vector", "sharded_probe"):
            with pytest.raises(UnsupportedKernel, match="single-device"):
                api.launch_batch(kernel, grid=GRID, block=BLOCK,
                                 args_list=[vecadd_args(rng),
                                            vecadd_args(rng)],
                                 backend=backend)
    finally:
        backends.unregister_backend("sharded_probe")


# -------------------------------------------------------------------------
# service-level batching
# -------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_batches_compatible_requests(kernel, backend):
    rng = np.random.default_rng(4)
    argses = [vecadd_args(rng) for _ in range(4)]
    kept = [{k: v.clone() for k, v in a.items()} for a in argses]
    svc = _service(backend, autostart=False, max_batch=8)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        tickets = [svc.submit("vecadd", a) for a in argses]
        svc.start()
        results = [t.result(timeout=120) for t in tickets]
        st = svc.stats()
        # all four queued requests stacked into ONE dispatch
        assert st.batch_occupancy.get(4) == 1, st.batch_occupancy
        assert st.batched_requests == 4
        assert all(t.batch_size == 4 for t in tickets)
        for a, r, k in zip(argses, results, kept):
            want = api.launch(kernel, grid=GRID, block=BLOCK, args=a,
                              backend=backend)
            assert _bits(r["c"]) == _bits(want["c"])
            # the tenant's tensors are not written
            assert all(torch.equal(a[n], k[n]) for n in a)
    finally:
        svc.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_isolates_incompatible_specializations(kernel, backend):
    """Different arg shapes -> different batch keys -> separate
    dispatches."""
    other = cuda_suite.make_vecadd(N // 2)
    rng = np.random.default_rng(5)
    svc = _service(backend, autostart=False)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        svc.register("half", other, grid=GRID // 2, block=BLOCK)
        ta = [svc.submit("vecadd", vecadd_args(rng)) for _ in range(2)]
        a = vecadd_args(rng, N // 2)
        tb = svc.submit("half", a)
        svc.start()
        for t in [*ta, tb]:
            t.result(timeout=120)
        st = svc.stats()
        assert st.batch_occupancy.get(2) == 1      # the vecadd pair
        assert st.batch_occupancy.get(1) == 1      # the lone half request
        assert _bits(tb.result()["c"]) == _bits(a["a"] + a["b"])
        # the single ran on the endpoint's named stream
        assert st.streams["launches"] == 1
    finally:
        svc.close()


# -------------------------------------------------------------------------
# robustness: backpressure, timeout, fault isolation
# -------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_backpressure_raises_overloaded(kernel, backend):
    rng = np.random.default_rng(6)
    svc = _service(backend, autostart=False, max_queue=2)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        svc.submit("vecadd", vecadd_args(rng))
        svc.submit("vecadd", vecadd_args(rng))
        with pytest.raises(ServiceOverloaded):
            svc.submit("vecadd", vecadd_args(rng))
        assert svc.stats().rejected == 1
    finally:
        svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit("vecadd", vecadd_args(rng))


@pytest.mark.parametrize("backend", BACKENDS)
def test_queue_timeout_fails_request_not_worker(kernel, backend):
    rng = np.random.default_rng(7)
    svc = _service(backend, autostart=False)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        stale = svc.submit("vecadd", vecadd_args(rng), timeout=0.01)
        fresh = svc.submit("vecadd", vecadd_args(rng))
        time.sleep(0.05)
        svc.start()
        with pytest.raises(ServiceTimeout):
            stale.result(timeout=120)
        fresh.result(timeout=120)              # worker kept serving
        st = svc.stats()
        assert st.timed_out == 1 and st.completed == 1
    finally:
        svc.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_client_side_result_timeout(kernel, backend):
    rng = np.random.default_rng(8)
    svc = _service(backend, autostart=False)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        t = svc.submit("vecadd", vecadd_args(rng))
        with pytest.raises(ServiceTimeout):   # worker never started
            t.result(timeout=0.01)
    finally:
        svc.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_tenant_fault_isolated_from_cobatched_and_subsequent(kernel,
                                                             backend):
    rng = np.random.default_rng(9)
    svc = _service(backend, autostart=False, max_batch=8)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        good_args = [vecadd_args(rng) for _ in range(2)]
        bad_args = vecadd_args(rng)
        # const-space violation: ConstArray bound to the write buffer
        bad_args["c"] = memory.ConstArray(torch.zeros(N))
        goods = [svc.submit("vecadd", a) for a in good_args]
        bad = svc.submit("vecadd", bad_args)
        svc.start()
        with pytest.raises(memory.UnsupportedSpace):
            bad.result(timeout=120)
        # co-batched requests survived the fallback to singles
        for t, a in zip(goods, good_args):
            want = api.launch(kernel, grid=GRID, block=BLOCK, args=a,
                              backend=backend)
            assert _bits(t.result(timeout=120)["c"]) == _bits(want["c"])
        # ... and the worker keeps serving afterwards
        after = svc.submit("vecadd", vecadd_args(rng))
        after.result(timeout=120)
        st = svc.stats()
        assert st.failed == 1 and st.completed == 3
        assert st.batched_requests == 0        # the batch fell through
    finally:
        svc.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_freed_handle_rejected_at_admission(kernel, backend):
    rng = np.random.default_rng(10)
    svc = _service(backend, autostart=False)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        buf = memory.cuda_malloc((N,), torch.float32, device="cpu")
        memory.cuda_free(buf)
        args = vecadd_args(rng)
        args["a"] = buf
        with pytest.raises(memory.CudaError):
            svc.submit("vecadd", args)
        ok = svc.submit("vecadd", vecadd_args(rng))
        svc.start()
        ok.result(timeout=120)
    finally:
        svc.close()


def test_malformed_requests_rejected(kernel):
    svc = _service("loop", autostart=False)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        with pytest.raises(ServiceError, match="already registered"):
            svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        with pytest.raises(ServiceError, match="not in the kernel"):
            svc.register("other", kernel, grid=GRID, block=BLOCK,
                         bound={"zzz": torch.zeros(4)})
        rng = np.random.default_rng(11)
        args = vecadd_args(rng)
        with pytest.raises(ServiceError, match="unknown endpoint"):
            svc.submit("nope", args)
        with pytest.raises(ServiceError, match="missing buffer"):
            svc.submit("vecadd", {"a": args["a"]})
        extra = dict(args, zzz=torch.zeros(4))
        with pytest.raises(ServiceError, match="unknown buffer"):
            svc.submit("vecadd", extra)
    finally:
        svc.close()


# -------------------------------------------------------------------------
# stats accounting
# -------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_stats_counters_add_up(kernel, backend):
    rng = np.random.default_rng(12)
    svc = _service(backend, autostart=False, max_queue=4)
    try:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        tickets = [svc.submit("vecadd", vecadd_args(rng)) for _ in range(3)]
        bad = vecadd_args(rng)
        bad["c"] = memory.ConstArray(torch.zeros(N))
        tickets.append(svc.submit("vecadd", bad))
        with pytest.raises(ServiceOverloaded):
            svc.submit("vecadd", vecadd_args(rng))
        svc.start()
        for t in tickets:
            try:
                t.result(timeout=120)
            except memory.UnsupportedSpace:
                pass
        st = svc.stats()
        assert st.submitted == 4 and st.rejected == 1
        assert st.submitted == st.completed + st.failed + st.timed_out
        assert sum(k * v for k, v in st.batch_occupancy.items()) \
            >= st.completed + st.failed
        assert sum(st.batch_occupancy.values()) == st.dispatches
        assert st.queue_depth == 0 and st.max_queue_depth == 4
        lat = st.kernels["vecadd"]
        assert lat["count"] == st.completed
        assert 0 < lat["p50_ms"] <= lat["p99_ms"]
        assert 0.0 <= st.warm_hit_rate <= 1.0
        # the three good requests ran as singles on the named stream
        assert st.streams["launches"] == st.completed == 3
    finally:
        svc.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_stats_json_roundtrips(kernel, backend):
    rng = np.random.default_rng(13)
    with _service(backend) as svc:
        svc.register("vecadd", kernel, grid=GRID, block=BLOCK)
        svc.submit("vecadd", vecadd_args(rng)).result(timeout=120)
        doc = svc.stats().to_json()
    parsed = json.loads(json.dumps(doc))
    assert parsed["completed"] == 1
    assert "vecadd" in parsed["kernels"]
    assert parsed["batch_occupancy"] == {"1": 1}
