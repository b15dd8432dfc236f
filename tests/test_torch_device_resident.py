"""The port's device-resident chain modes against the JAX package, on the
CPU.

The seven chain entries (bfs_frontier, pathfinder, needle_nw, hotspot,
srad_step, nn, kmeans) run through ``run_entry(..., chain_mode="device" |
"graph")`` under ``vector`` and ``loop`` on the same inputs
(``default_rng(42)``) as the reference's ``run_entry`` in the same mode.
The port's output must be bit for bit its own host mode's, and the
reference's on integer buffers and on kmeans's (float sums of integer
values) - within the entry's ``tol`` for the other float32 buffers, which
XLA and PyTorch may contract or order differently - with
``SuiteEntry.iteration_state`` (the stop-cadence scratch) left out.  The
replay counters (``ChainStats``) must equal the reference's: the 1-in-k
stop poll, one replay for a fixed-repeat chain, a repeat bound never
exceeded, and no capture at all for a one-iteration chain.

The ``loop`` cells of hotspot and nn run at smaller sizes through both
packages' ``entry_<name>(**kw)``: the port's ``loop`` takes 10-20 s a run
at the suite's sizes.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cuda_suite as jsuite  # noqa: E402
from repro.core import kernel as jkernel  # noqa: E402
from repro.core.api import launch as japi_launch  # noqa: E402
from repro.core.streams import Stream as JStream  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import api, cuda_suite, index  # noqa: E402
from repro_torch.core.kernel import (  # noqa: E402
    ChainStats,
    ChainStep,
    KernelDef,
    LaunchChain,
    UnsupportedKernel,
)
from repro_torch.core.streams import Stream  # noqa: E402

CHAINS = ("bfs_frontier", "pathfinder", "needle_nw", "hotspot",
          "srad_step", "nn", "kmeans")
#: float buffers held bit for bit against the reference (kmeans's sums
#: are of integer-valued floats, its centroids one IEEE division of them)
BIT_EXACT = ("kmeans",)
#: the loop cells' sizes, where the suite's are slow under the port's loop
LOOP_SIZES = {"hotspot": {"h": 16, "w": 16, "iters": 3},
              "nn": {"n": 64, "block": 16, "knn": 4}}


@functools.cache
def _entries(name: str, backend: str):
    kw = LOOP_SIZES.get(name, {}) if backend == "loop" else {}
    if not kw:
        return ({e.name: e for e in jsuite.build_suite(1)}[name],
                {e.name: e for e in cuda_suite.build_suite(1)}[name])
    return (getattr(jsuite, f"entry_{name}")(**kw),
            getattr(cuda_suite, f"entry_{name}")(**kw))


def _args(name, backend):
    return _entries(name, backend)[0].make_args(np.random.default_rng(42))


def _np(v):
    return np.asarray(v.value if hasattr(v, "value") else v)


@functools.cache
def _port_host(name, backend):
    out, want = cuda_suite.run_entry(_entries(name, backend)[1], backend,
                                     args=_args(name, backend), device="cpu")
    return {k: _np(v) for k, v in out.items()}, want


def _port(name, backend, mode, **kw):
    stats = ChainStats()
    out, _ = cuda_suite.run_entry(_entries(name, backend)[1], backend,
                                  args=_args(name, backend), device="cpu",
                                  chain_mode=mode, chain_stats=stats,
                                  with_reference=False, **kw)
    return {k: _np(v) for k, v in out.items()}, stats


def _reference(name, backend, mode, **kw):
    stats = jkernel.ChainStats()
    out, _ = jsuite.run_entry(_entries(name, backend)[0], backend,
                              args=_args(name, backend), chain_mode=mode,
                              chain_stats=stats, with_reference=False, **kw)
    return {k: np.asarray(v) for k, v in out.items()}, stats


def _same_stats(port, ref):
    return ((port.iterations, port.launches, port.host_syncs,
             port.graph_replays)
            == (ref.iterations, ref.launches, ref.host_syncs,
                ref.graph_replays))


def _assert_bits(entry, a, b, context):
    for k in a:
        if k in entry.iteration_state:
            continue
        assert a[k].dtype == b[k].dtype, f"{context}: {k} dtype"
        assert a[k].tobytes() == b[k].tobytes(), (
            f"{context}: buffer {k!r} not bit-identical")


@pytest.mark.parametrize("mode", ("device", "graph"))
@pytest.mark.parametrize("backend", ("vector", "loop"))
@pytest.mark.parametrize("name", CHAINS)
def test_chain_mode_matches_host_mode_and_reference(name, backend, mode):
    jentry, entry = _entries(name, backend)
    host, want = _port_host(name, backend)
    out, stats = _port(name, backend, mode)
    _assert_bits(entry, host, out, f"{name}/{backend}/{mode} vs host")
    ref, jstats = _reference(name, backend, mode)
    assert _same_stats(stats, jstats), (stats, jstats)
    assert set(out) == set(ref)
    for k, r in ref.items():
        if k in entry.iteration_state:
            continue
        assert out[k].dtype == r.dtype, k
        if r.dtype.kind == "f" and name not in BIT_EXACT:
            np.testing.assert_allclose(out[k], r, rtol=entry.tol,
                                       atol=entry.tol, err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], r, err_msg=k)
    for k, v in want.items():
        np.testing.assert_allclose(out[k], v, rtol=entry.tol, atol=entry.tol,
                                   err_msg=k)


@pytest.mark.parametrize("name, check_every", [
    ("bfs_frontier", 1), ("bfs_frontier", 3), ("bfs_frontier", 16),
    ("kmeans", 1), ("kmeans", 2), ("kmeans", 5)])
@pytest.mark.parametrize("mode", ("device", "graph"))
def test_poll_period_counts_as_the_reference(name, check_every, mode):
    entry = _entries(name, "vector")[1]
    host, _ = _port_host(name, "vector")
    out, stats = _port(name, "vector", mode, check_every=check_every)
    _assert_bits(entry, host, out, f"{name}/check_every={check_every}")
    _, jstats = _reference(name, "vector", mode, check_every=check_every)
    assert _same_stats(stats, jstats), (stats, jstats)


def test_host_syncs_drop_to_one_in_k():
    # bfs reads its stop flag back every iteration host-hop; the
    # device-resident replay every check_every = 4 iterations
    entry = _entries("bfs_frontier", "vector")[1]
    host = ChainStats()
    cuda_suite.run_entry(entry, "vector", device="cpu", chain_stats=host)
    assert host.iterations > 4 and host.host_syncs >= host.iterations - 1
    k = entry.chain.check_every
    assert k == 4
    _, dev = _port("bfs_frontier", "vector", "device")
    assert dev.host_syncs <= host.host_syncs / k + 1
    assert dev.syncs_per_iteration <= 1.0 / k + 0.01
    assert dev.iterations < host.iterations + k     # bounded overshoot


@pytest.mark.parametrize("name", ("pathfinder", "needle_nw", "hotspot",
                                  "srad_step", "nn"))
def test_fixed_repeat_chain_graph_is_one_replay(name):
    _, stats = _port(name, "vector", "graph")
    entry = _entries(name, "vector")[1]
    assert (stats.graph_replays, stats.host_syncs) == (1, 0)
    assert stats.iterations == entry.chain.repeat
    assert stats.launches == entry.chain.repeat * len(entry.chain.steps)


def test_stop_flag_chain_graph_polls_per_unit():
    _, stats = _port("bfs_frontier", "vector", "graph")
    assert stats.graph_replays >= 2
    assert stats.host_syncs <= stats.graph_replays
    assert stats.host_syncs < stats.iterations


def test_chain_mode_rejected_for_single_launch_entries():
    vecadd = cuda_suite.entry_vecadd()
    with pytest.raises(ValueError, match="needs a LaunchChain"):
        cuda_suite.run_entry(vecadd, "vector", chain_mode="device",
                             device="cpu")
    with pytest.raises(ValueError, match="unknown chain_mode"):
        cuda_suite.run_entry(cuda_suite.entry_pathfinder(), "vector",
                             chain_mode="warp9", device="cpu")


def test_every_chain_entry_declares_the_reference_hooks():
    for name in CHAINS:
        jchain, chain = (e.chain for e in _entries(name, "vector"))
        assert chain.check_every == jchain.check_every, name
        assert (chain.device_stop is None) == (jchain.device_stop is None)
        for js, ts in zip(jchain.steps, chain.steps, strict=True):
            assert (ts.update is None) == (js.update is None), name
            assert (ts.prepare is None) == (js.prepare is None), name


# --- driver-level contracts, on a one-kernel counting chain ------------------
def _counting_chain(repeat, stop_after=None, with_update=True,
                    check_every=1):
    """A chain bumping ``cnt[0]`` once an iteration, in both packages."""
    import jax.numpy as jnp

    def jstage(ctx, st):
        idx = jnp.where(ctx.tid == 0, 0, jsuite.OOB)
        return st.set_glob(cnt=st.glob["cnt"].at[idx].add(1, mode="drop"))

    def stage(ctx, st):
        idx = cuda_suite._where(ctx.tid == 0, 0, cuda_suite.OOB)
        return st.set_glob(cnt=index.put(st.glob["cnt"], idx, 1, op="add"))

    chains = []
    for pkg, kdef, step_t, chain_t, fn in (
            ("ref", jkernel.KernelDef, jkernel.ChainStep,
             jkernel.LaunchChain, jstage),
            ("port", KernelDef, ChainStep, LaunchChain, stage)):
        k = kdef("count", (fn,), writes=("cnt",), reads=("cnt",))
        step = step_t(k, 1, 32,
                      prepare=None if with_update else (lambda it, b: {}),
                      update=(lambda b: {}) if with_update else None)
        stop = None
        if stop_after is not None:
            stop = lambda b: int(np.asarray(b["cnt"])[0]) >= stop_after
        chains.append(chain_t(steps=(step,), repeat=repeat, stop=stop,
                              check_every=check_every))
    return chains


def _cnt(n=8):
    return {"cnt": torch.zeros(n, dtype=torch.int32)}


def _jcnt(n=8):
    import jax.numpy as jnp
    return {"cnt": jnp.zeros(n, jnp.int32)}


def test_run_device_matches_run_for_plain_chain():
    _, chain = _counting_chain(repeat=5)

    def launch_step(step, b):
        return api.launch(step.kernel, grid=step.grid, block=step.block,
                          args=b, backend="loop")

    a = chain.run(launch_step, _cnt())
    b = chain.run_device(launch_step, _cnt())
    assert int(a["cnt"][0]) == 5
    assert torch.equal(a["cnt"], b["cnt"])


def test_run_graph_rejects_host_only_prepare():
    _, chain = _counting_chain(repeat=4, with_update=False)
    with pytest.raises(UnsupportedKernel, match="ChainStep.update"):
        chain.run_graph(Stream(_cnt()), backend="loop")


@pytest.mark.parametrize("repeat, check_every, stop_after", [
    (6, 4, 10_000),       # 5 remaining = one unit of 4 + a tail of 1
    (6, 4, 3),            # the stop fires inside the first unit
    (9, 2, 10_000), (7, 3, 5), (1, 1, None), (5, 1, None), (2, 8, 10_000)])
def test_run_graph_counts_as_the_reference(repeat, check_every, stop_after):
    # the tail runs eagerly, so the chain never exceeds repeat; repeat 1
    # launches once and captures nothing
    jchain, chain = _counting_chain(repeat, stop_after,
                                    check_every=check_every)
    stats, jstats = ChainStats(), jkernel.ChainStats()
    out = chain.run_graph(Stream(_cnt()), stats=stats, backend="loop")
    jout = jchain.run_graph(JStream(_jcnt()), stats=jstats, backend="loop")
    assert _same_stats(stats, jstats), (stats, jstats)
    np.testing.assert_array_equal(out["cnt"].numpy(), np.asarray(jout["cnt"]))
    assert int(out["cnt"][0]) == stats.iterations <= repeat


@pytest.mark.parametrize("check_every", (1, 2, 3))
def test_run_device_counts_as_the_reference(check_every):
    jchain, chain = _counting_chain(7, stop_after=4, check_every=check_every)
    stats, jstats = ChainStats(), jkernel.ChainStats()

    def launch_step(step, b):
        return api.launch(step.kernel, grid=step.grid, block=step.block,
                          args=b, backend="vector")

    def jlaunch_step(step, b):
        return japi_launch(step.kernel, grid=step.grid, block=step.block,
                           args=b, backend="vector")

    out = chain.run_device(launch_step, _cnt(), stats=stats)
    jout = jchain.run_device(jlaunch_step, _jcnt(), stats=jstats)
    assert _same_stats(stats, jstats), (stats, jstats)
    np.testing.assert_array_equal(out["cnt"].numpy(), np.asarray(jout["cnt"]))


def test_captured_unit_replays_advance_the_chain_each_time():
    # one capture of a unit, replayed three times: the heap advances by
    # the unit every replay (the steady state the reference's membench
    # measures), exactly as three unit's worth of host-mode iterations
    entry = cuda_suite.entry_needle_nw(n=16)
    args = entry.make_args(np.random.default_rng(3))
    chain = dataclasses.replace(entry.chain, repeat=1 + 3 * 4)
    stream = Stream(carry.from_reference(args, device="cpu"))
    step = chain.steps[0]
    stream.launch(step.kernel, grid=step.grid, block=step.block,
                  backend="vector")
    ex = chain.capture_unit(stream, 4, backend="vector")
    for _ in range(3):
        ex.launch(stream)
    host, _ = cuda_suite.run_entry(
        dataclasses.replace(entry, chain=chain), "vector", args=args,
        device="cpu", with_reference=False)
    assert torch.equal(stream.buffers["score"], host["score"])
    assert int(stream.buffers["diag"][0]) == int(host["diag"][0]) == 14
    assert ex.launches == 3 and stream.stats.graph_launches == 3
