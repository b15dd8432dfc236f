"""The port's shard backends (``repro_torch.core.lower_shard``) and the
launch options that reach them, on the CPU's host workers.

The cases of ``tests/test_shard.py`` ported onto the port, each at 1, 2
and 4 host workers (``CUPBOP_HOST_DEVICES``, read at every launch) where
the reference's runs at its process's device count: the grain tail, the
combine modes and their refusals, ``devices`` out of range and in the
cache key, single-device backends ignoring the options, a sharded launch
in a captured graph, and the LaunchConfig error paths.  The suite-wide
bit checks (``shard`` = ``loop``, ``shard_vector`` = ``vector`` at 1, 2
and 4 workers) are split over ``tests/test_torch_suite_shard_*.py`` by
the ``loop`` lowering's cost, through :func:`shard_equals_inner`; the
reference's 4-device bits are in ``tests/test_torch_suite_shard_parity.py``
and the every-block-runs-once property in
``tests/test_torch_shard_property.py``.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ConstArray,
    DeviceBuffer,
    Stream,
    UnknownBackend,
    UnsupportedKernel,
    api,
    atomics,
    cuda_suite,
    get_backend,
    index,
    launch,
    lower_loop,
    lower_shard,
)
from repro_torch.core.cuda_suite import build_suite, make_vecadd  # noqa: E402
from repro_torch.core.kernel import KernelDef  # noqa: E402
from repro_torch.core.memory import host_array  # noqa: E402

SUITE = build_suite(scale=1)
BY_NAME = {e.name: e for e in SUITE}
HOSTS = (1, 2, 4)
#: each shard backend's inner lowering, whose bits it owes
INNER = {"shard": "loop", "shard_vector": "vector"}


@pytest.fixture
def hosts(monkeypatch, request):
    monkeypatch.setenv(lower_shard.HOST_DEVICES_ENV, str(request.param))
    return request.param


def _bits(t) -> bytes:
    return host_array(t).tobytes()


def make_blockmax(n: int, combines) -> KernelDef:
    """Every block atomically maxes into out[0] (a cross-shard collision)."""

    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        v = index.take(st.glob["x"], torch.clamp(gid, max=n - 1))
        v = torch.where(gid < n, v, -torch.inf)
        idx = torch.zeros(v.shape, dtype=torch.int32)
        return st.set_glob(out=ctx.atomic_max(st.glob["out"], idx, v))

    return KernelDef("blockmax", (stage,), writes=("out",),
                     reads=("x", "out"), combines=combines)


def make_blocksum(n_blocks: int, block: int, combines) -> KernelDef:
    """y[bid] = sum of the block's thread values (an owned-slice write)."""
    n = n_blocks * block

    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        v = torch.where(gid < n,
                        index.take(st.glob["x"], torch.clamp(gid, max=n - 1)),
                        0.0)
        bid = torch.full(v.shape, ctx.bid, dtype=torch.int32)
        return st.set_glob(y=ctx.atomic_add(st.glob["y"], bid, v))

    return KernelDef("blocksum", (stage,), writes=("y",), reads=("x", "y"),
                     combines=combines)


_RUNS: dict[tuple, dict[str, np.ndarray]] = {}


def suite_out(name: str, backend: str, grain: int = 1) -> dict:
    """A suite entry's buffers after one run on ``backend`` at the host
    pool the environment sets, on ``run_entry``'s default inputs;
    memoized per process, so a file's tests run each (entry, backend,
    pool, grain) once."""
    pool = lower_shard.pool_size("cpu")
    key = (name, backend, pool if backend in INNER else None, grain)
    if key not in _RUNS:
        out, _ = cuda_suite.run_entry(BY_NAME[name], backend, grain=grain,
                                      device="cpu", with_reference=False)
        _RUNS[key] = {k: host_array(getattr(v, "value", v))
                      for k, v in out.items()}
    return _RUNS[key]


def shard_equals_inner(name: str, backend: str, hosts: int,
                       grain: int = 1) -> None:
    """``backend`` at ``hosts`` workers gives its inner lowering's bits on
    every buffer of entry ``name`` outside ``nondeterministic_shard``."""
    entry = BY_NAME[name]
    assert lower_shard.pool_size("cpu") == hosts
    want = suite_out(name, INNER[backend])
    got = suite_out(name, backend, grain)
    assert set(got) == set(want)
    diff = [k for k in want if k not in entry.nondeterministic_shard
            and got[k].tobytes() != want[k].tobytes()]
    assert not diff, (f"{name}: {diff} differ between {INNER[backend]} and "
                      f"{backend} at {hosts} host workers, grain {grain}")


def _vecadd_args(n=256):
    return {k: torch.zeros(n) for k in "abc"}


# --- the grain tail -----------------------------------------------------------
@pytest.mark.parametrize("hosts", HOSTS, indirect=True)
@pytest.mark.parametrize("grain", [2, 3, "average"])
def test_shard_grain_equals_loop(grain, hosts):
    """Grain fetch loops round a shard's range up; the tail slots are
    masked as the NEXT shard's blocks, not run twice."""
    n_blocks, block = 6, 64
    k = make_blocksum(n_blocks, block, combines={})
    rng = np.random.default_rng(9)
    args = {"x": torch.from_numpy(rng.standard_normal(n_blocks * block,
                                                      dtype=np.float32)),
            "y": torch.zeros(n_blocks)}
    o1 = launch(k, grid=n_blocks, block=block, args=args, backend="loop")
    for backend in ("shard", "shard_vector"):
        o2 = launch(k, grid=n_blocks, block=block, args=args,
                    backend=backend, grain=grain, pool=2)
        assert _bits(o1["y"]) == _bits(o2["y"]), (backend, grain, hosts)


def test_shard_devices_1_is_the_inner_lowering_verbatim(monkeypatch):
    monkeypatch.setenv(lower_shard.HOST_DEVICES_ENV, "4")
    entry = SUITE[0]
    calls = []
    real = lower_loop.run

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(lower_shard, "_INNER",
                        {**lower_shard._INNER, "loop": spy})
    out, want = cuda_suite.run_entry(entry, "shard", devices=1,
                                     device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(host_array(out[k]), v, rtol=2e-5,
                                   atol=2e-5)
    assert len(calls) == 1 and "bid_start" not in calls[0]
    calls.clear()
    cuda_suite.run_entry(entry, "shard", devices=4, device="cpu")
    assert [c["bid_start"] for c in calls] == [0, 8, 16, 24]
    assert {c["count"] for c in calls} == {8}


def test_shard_registered_with_capabilities():
    for name in ("shard", "shard_vector"):
        b = get_backend(name)
        assert b.supports("multi_device", "barrier", "warp", "dim3")
        assert not b.supports("native")
    for name in ("loop", "loop_nowarp", "naive", "vector", "cuda"):
        assert not get_backend(name).supports("multi_device")


def test_shard_check_keeps_the_inner_lowerings_check():
    """shard refuses what loop refuses (a warp kernel's block must be a
    multiple of 32); shard_vector takes it, as vector does."""
    k = cuda_suite.make_reduce_warp(64, 64)
    for backend, refuses in (("loop", True), ("shard", True),
                             ("vector", False), ("shard_vector", False)):
        if refuses:
            with pytest.raises(UnsupportedKernel, match="multiple of"):
                get_backend(backend).check(k, 48)
        else:
            get_backend(backend).check(k, 48)


# --- combine declarations -----------------------------------------------------
@pytest.mark.parametrize("hosts", HOSTS, indirect=True)
def test_combine_max_mode(hosts):
    n, block, grid = 1024, 64, 16
    k = make_blockmax(n, combines={"out": "max"})
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n, dtype=np.float32)
    for backend in ("shard", "shard_vector"):
        out = launch(k, grid=grid, block=block,
                     args={"x": torch.from_numpy(x),
                           "out": torch.full((1,), -torch.inf)},
                     backend=backend)
        assert host_array(out["out"])[0] == x.max()


@pytest.mark.parametrize("hosts", HOSTS, indirect=True)
def test_combine_concat_mode_and_fallback(hosts):
    rng = np.random.default_rng(5)
    for n_blocks in (16, 13):      # 13: indivisible -> warned sum fallback
        k = make_blocksum(n_blocks, 64, combines={"y": "concat"})
        x = rng.standard_normal(n_blocks * 64, dtype=np.float32)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = launch(k, grid=n_blocks, block=64,
                         args={"x": torch.from_numpy(x),
                               "y": torch.zeros(n_blocks)},
                         backend="shard")
        want = x.reshape(n_blocks, 64).sum(1, dtype=np.float32)
        np.testing.assert_allclose(host_array(out["y"]), want, rtol=1e-4)
        n_dev = min(hosts, n_blocks)
        expect_warn = n_dev > 1 and n_blocks % n_dev != 0
        got = [str(w.message) for w in caught
               if "concat" in str(w.message)]
        assert bool(got) == expect_warn, (n_blocks, n_dev, got)
        if got:
            assert "falling back to 'sum'" in got[0]


def test_combine_unknown_mode_rejected():
    with pytest.raises(ValueError, match="combine mode"):
        make_blocksum(8, 64, combines={"y": "xor"})


def test_combine_on_unwritten_buffer_rejected():
    with pytest.raises(ValueError, match="not in writes"):
        make_blocksum(8, 64, combines={"x": "sum"})


def test_combines_changes_fingerprint():
    a = make_blocksum(8, 64, combines={})
    b = make_blocksum(8, 64, combines={"y": "concat"})
    assert a.fingerprint() != b.fingerprint()


def test_combine_modes_refusals_past_the_kerneldef_check():
    """The shard backend's own refusals, for a kernel whose declaration
    got past ``KernelDef``'s (an unknown mode, a stray buffer)."""
    k = make_blocksum(8, 64, combines={"y": "sum"})
    bad = dataclasses.replace(k)
    object.__setattr__(bad, "combines", {"y": "xor"})
    with pytest.raises(UnsupportedKernel, match="cross-shard combine"):
        lower_shard.combine_modes(bad)
    object.__setattr__(bad, "combines", {"y": "sum", "x": "sum"})
    with pytest.raises(UnsupportedKernel, match="non-written"):
        lower_shard.combine_modes(bad)
    assert lower_shard.combine_modes(k) == {"y": "sum"}
    assert lower_shard.combine_modes(
        make_blocksum(8, 64, combines={})) == {"y": "sum"}


# --- combine_partials: the collective's arithmetic ----------------------------
def test_combine_partials_sum_folds_shard_0_first():
    before = torch.tensor([1e8, -0.0, torch.inf, 2.0, 0.0])
    afters = [torch.tensor([1e8 + 1, -0.0, torch.inf, 2.0, 1.0]),
              torch.tensor([-1e8 + 1e8, -0.0, torch.inf, 2.0, 2.0]),
              torch.tensor([1e8 + 1, -0.0, torch.inf, 2.0, 3.0])]
    got = atomics.combine_partials("sum", before, afters)
    acc = torch.zeros_like(before)
    for a in afters:
        acc = acc + (a - before)
    assert _bits(got) == _bits(before + acc)
    # an untouched -0.0 comes back +0.0, an untouched inf NaN
    assert _bits(got[1:2]) == _bits(torch.tensor([0.0]))
    assert torch.isnan(got[2])
    assert got[4] == 6.0


def test_combine_partials_max_min_pass_over_nan_and_keep_earlier_zero():
    nan = torch.nan
    before = torch.zeros(4)
    afters = [torch.tensor([nan, 0.0, -0.0, nan]),
              torch.tensor([1.0, -0.0, 0.0, nan])]
    mx = atomics.combine_partials("max", before, afters)
    mn = atomics.combine_partials("min", before, afters)
    assert mx[0] == 1.0 and mn[0] == 1.0
    assert _bits(mx[1:3]) == _bits(torch.tensor([0.0, -0.0]))
    assert _bits(mn[1:3]) == _bits(torch.tensor([0.0, -0.0]))
    assert mx[3] == -torch.inf and mn[3] == torch.inf
    ints = [torch.tensor([5, -3], dtype=torch.int32),
            torch.tensor([2 ** 31 - 1, -2 ** 31], dtype=torch.int32)]
    z = torch.zeros(2, dtype=torch.int32)
    assert atomics.combine_partials("max", z, ints).tolist() == [
        2 ** 31 - 1, -3]
    assert atomics.combine_partials("min", z, ints).tolist() == [
        5, -2 ** 31]
    assert atomics.combine_partials("sum", z, ints).tolist() == [
        -2 ** 31 + 4, 2 ** 31 - 3]


def test_combine_partials_refuses_concat_and_unknown_modes():
    for mode in ("concat", "xor"):
        with pytest.raises(ValueError, match="not a collective reduction"):
            atomics.combine_partials(mode, torch.zeros(1), [torch.zeros(1)])


# --- the pool and device options ----------------------------------------------
@pytest.mark.parametrize("hosts", HOSTS, indirect=True)
def test_devices_out_of_range_rejected(hosts):
    k = make_vecadd(256)
    with pytest.raises(ValueError, match="devices must be >= 1"):
        launch(k, grid=2, block=128, args=_vecadd_args(), backend="shard",
               devices=0)
    with pytest.raises(ValueError, match="available") as err:
        launch(k, grid=2, block=128, args=_vecadd_args(), backend="shard",
               devices=hosts + 1)
    assert f"{lower_shard.HOST_DEVICES_ENV}={hosts + 1}" in str(err.value)


def test_resolve_devices_rules(monkeypatch):
    monkeypatch.setenv(lower_shard.HOST_DEVICES_ENV, "4")
    assert lower_shard.resolve_devices(None, 64) == 4     # the whole pool
    assert lower_shard.resolve_devices(None, 3) == 3      # capped by grid
    assert lower_shard.resolve_devices(2, 64) == 2
    monkeypatch.delenv(lower_shard.HOST_DEVICES_ENV)
    assert lower_shard.pool_size("cpu") == 1
    for raw in ("0", "four"):
        monkeypatch.setenv(lower_shard.HOST_DEVICES_ENV, raw)
        with pytest.raises(ValueError, match=lower_shard.HOST_DEVICES_ENV):
            lower_shard.pool_size("cpu")


def test_the_pool_on_cuda_tensors_is_the_cards(monkeypatch):
    """On CUDA tensors the pool is torch.cuda.device_count(), whatever
    the host variable says; asking for more names the card count."""
    monkeypatch.setenv(lower_shard.HOST_DEVICES_ENV, "4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert lower_shard.pool_size("cuda") == 1
    assert lower_shard.resolve_devices(None, 64, "cuda") == 1
    with pytest.raises(ValueError, match="available") as err:
        lower_shard.resolve_devices(2, 64, torch.device("cuda", 0))
    assert "card" in str(err.value)
    assert lower_shard.HOST_DEVICES_ENV not in str(err.value)


def test_devices_in_cache_key():
    api.cache_clear()
    k = make_vecadd(256)
    for axis in ("blocks", "blocks", "workers"):
        launch(k, grid=2, block=128, args=_vecadd_args(), backend="shard",
               devices=1, shard_axis=axis)
    stats = api.cache_stats()
    assert stats.misses == 2 and stats.hits == 1
    launch(k, grid=2, block=128, args=_vecadd_args(), backend="shard")
    assert api.cache_stats().misses == 3       # devices=None is its own
    api.cache_clear()


def test_single_device_backends_ignore_device_opts():
    """devices= must not break - or re-specialize - plain backends."""
    api.cache_clear()
    k = make_vecadd(256)
    for backend in ("loop", "vector"):
        launch(k, grid=2, block=128, args=_vecadd_args(), backend=backend)
        launch(k, grid=2, block=128, args=_vecadd_args(), backend=backend,
               devices=4, shard_axis="workers")
        launch(k, grid=2, block=128, args=_vecadd_args(), backend=backend,
               devices=1)
    stats = api.cache_stats()
    assert stats.hits == 4 and stats.misses == 2
    api.cache_clear()


def test_the_disk_key_carries_the_device_options(monkeypatch, tmp_path):
    """A multi-device launch fills compile_cache's devices / shard_axis;
    a single-device one leaves them at their defaults."""
    from repro_torch.core import compile_cache
    monkeypatch.setenv(lower_shard.HOST_DEVICES_ENV, "2")
    seen = []
    real = compile_cache.artifact_key

    def spy(*a, **kw):
        seen.append((kw["devices"], kw["shard_axis"]))
        return real(*a, **kw)

    monkeypatch.setattr(compile_cache, "artifact_key", spy)
    api.cache_clear()
    api.enable_disk_cache(str(tmp_path))
    try:
        k = make_vecadd(256)
        for backend in ("shard", "shard_vector", "loop"):
            launch(k, grid=2, block=128, args=_vecadd_args(),
                   backend=backend, devices=2, shard_axis="w")
    finally:
        api.disable_disk_cache()
        api.cache_clear()
    assert seen == [(2, "w"), (2, "w"), (None, "blocks")]


def test_compiled_and_on_take_the_device_options(monkeypatch):
    monkeypatch.setenv(lower_shard.HOST_DEVICES_ENV, "4")
    api.cache_clear()
    k = make_vecadd(256)
    a = api.compiled(k, grid=2, block=128, args=_vecadd_args(),
                     backend="shard", devices=2, shard_axis="x")
    b = api.compiled(k, grid=2, block=128, args=_vecadd_args(),
                     backend="shard", devices=2, shard_axis="x")
    c = api.compiled(k, grid=2, block=128, args=_vecadd_args(),
                     backend="shard", devices=1, shard_axis="x")
    assert a is b and a is not c
    assert a.key[-2:] == (2, "x")
    cfg = k[2, 128].on(backend="shard", devices=2, shard_axis="x")
    assert (cfg.devices, cfg.shard_axis) == (2, "x")
    rng = np.random.default_rng(0)
    args = {"a": torch.from_numpy(rng.standard_normal(256, np.float32)),
            "b": torch.from_numpy(rng.standard_normal(256, np.float32)),
            "c": torch.zeros(256)}
    got = cfg(args)["c"]
    assert _bits(got) == _bits(args["a"] + args["b"])
    assert api.cache_stats().hits == 2         # b, and the chevron's call
    api.cache_clear()


def test_launch_batch_refuses_the_shard_backends():
    k = make_vecadd(256)
    for backend in ("shard", "shard_vector"):
        with pytest.raises(UnsupportedKernel, match="single-device"):
            api.launch_batch(k, grid=2, block=128,
                             args_list=[_vecadd_args(), _vecadd_args()],
                             backend=backend)


def test_run_refuses_wrapped_buffers():
    k = make_vecadd(64)
    glob = {"a": ConstArray(torch.zeros(64)),
            "b": DeviceBuffer(torch.zeros(64)), "c": torch.zeros(64)}
    with pytest.raises(TypeError, match="wrapped buffer"):
        lower_shard.run(k, grid=1, block=64, glob=glob)


# --- streams and graphs -------------------------------------------------------
def _vecadd_heap(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal(n, dtype=np.float32)),
            "b": torch.from_numpy(rng.standard_normal(n, dtype=np.float32)),
            "c": torch.zeros(n)}


def _spy_shard(monkeypatch):
    seen = []
    real = lower_shard.run

    def spy(*a, **kw):
        seen.append((kw["devices"], kw["shard_axis"]))
        return real(*a, **kw)

    monkeypatch.setattr(lower_shard, "run", spy)
    return seen


@pytest.mark.parametrize("hosts", HOSTS, indirect=True)
def test_graph_replays_sharded_launch(hosts, monkeypatch):
    n, block = 1024, 128
    grid = -(-n // block)
    k = make_vecadd(n)
    bufs = _vecadd_heap(n, 11)
    seen = _spy_shard(monkeypatch)
    s = Stream(dict(bufs))
    g = s.begin_capture()
    k[grid, block, None, s].on(backend="shard")()
    k[grid, block, None, s].on(backend="shard_vector", devices=2,
                               shard_axis="w")()
    s.end_capture()
    assert [(nd.backend, nd.devices, nd.shard_axis) for nd in g.nodes] == [
        ("shard", None, "blocks"), ("shard_vector", 2, "w")]
    assert seen == []                          # capture runs nothing
    ex = g.instantiate(s.buffers)
    if hosts < 2:
        with pytest.raises(ValueError, match="available"):
            ex.launch(s)
        return
    ex.launch(s)
    assert seen == [(None, "blocks"), (2, "w")]
    np.testing.assert_allclose(
        s.memcpy_d2h("c"), host_array(bufs["a"] + bufs["b"]), rtol=1e-6)


@pytest.mark.parametrize("hosts", HOSTS, indirect=True)
def test_stream_launch_takes_the_device_options(hosts, monkeypatch):
    n, block = 1024, 128
    k = make_vecadd(n)
    bufs = _vecadd_heap(n, 12)
    seen = _spy_shard(monkeypatch)
    s = Stream(dict(bufs))
    s.launch(k, grid=n // block, block=block, backend="shard",
             devices=hosts, shard_axis="w")
    s.synchronize()
    assert seen == [(hosts, "w")]
    assert _bits(s.buffers["c"]) == _bits(bufs["a"] + bufs["b"])


# --- LaunchConfig error paths -------------------------------------------------
def test_chevron_not_a_tuple():
    with pytest.raises(TypeError, match="launch config"):
        make_vecadd(64)[64]


def test_chevron_wrong_arity():
    with pytest.raises(TypeError, match="launch config"):
        make_vecadd(64)[1, 64, None, None, "extra"]


def test_chevron_bad_dyn_shared_slot():
    with pytest.raises(TypeError, match="dyn_shared"):
        make_vecadd(64)[1, 64, "not-an-int"]


def test_chevron_bad_dim3():
    k = make_vecadd(64)
    with pytest.raises(ValueError, match="dim3"):
        k[(1, 2, 3, 4), 64]
    with pytest.raises(ValueError, match=">= 1"):
        k[0, 64]


def test_extern_shared_requires_dyn_shared():
    entry = [e for e in SUITE if e.name == "reverse"][0]
    cfg = entry.kernel[entry.grid, entry.block].on(backend="shard")
    with pytest.raises(ValueError, match="dyn_shared"):
        cfg(d=torch.zeros(512, dtype=torch.int32))


def test_unknown_backend_name():
    cfg = make_vecadd(64)[1, 64].on(backend="nope")
    with pytest.raises(UnknownBackend, match="nope"):
        cfg(**{k: torch.zeros(64) for k in "abc"})


def test_on_rejects_unknown_options():
    with pytest.raises(TypeError, match="unexpected"):
        make_vecadd(64)[1, 64].on(device=4)        # typo'd option name


def test_new_kernel_chevron_dim3_rank_mismatch():
    with pytest.raises(ValueError, match="dim3"):
        cuda_suite.make_bfs_frontier(64, 4)[(2, 1, 1, 1), 32]
    with pytest.raises(ValueError, match="dim3"):
        cuda_suite.make_pathfinder(256, 64)[4, (64, 1, 1, 1)]


def test_new_kernel_zero_size_grid():
    with pytest.raises(ValueError, match=">= 1"):
        cuda_suite.make_needle_nw(32)[0, 16]
    with pytest.raises(ValueError, match=">= 1"):
        cuda_suite.make_srad_update(32, 64)[(8, 0), (8, 8)]


@pytest.mark.parametrize("hosts", HOSTS, indirect=True)
def test_shard_launch_combines_missing_written_arg(hosts):
    """A kernel that declares combines for SOME writes but forgets one is
    refused by the shard backends (the implicit sum default is a trap)."""
    entry = cuda_suite.entry_bfs_frontier()
    partial = dataclasses.replace(entry.kernel,
                                  combines={"visited": "max", "nxt": "max",
                                            "active": "sum"})  # no 'dist'
    args = carry.from_reference(entry.make_args(np.random.default_rng(0)),
                                device="cpu")
    for backend in ("shard", "shard_vector"):
        with pytest.raises(UnsupportedKernel, match="missing written"):
            launch(partial, grid=entry.grid, block=entry.block, args=args,
                   backend=backend)
    # the loop backend doesn't combine, so it still accepts the kernel
    launch(partial, grid=entry.grid, block=entry.block, args=args,
           backend="loop")
