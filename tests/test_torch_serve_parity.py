"""The port's serving tier and disk cache against the reference's.

* ``launch_batch`` rows against the reference's ``launch_batch`` rows on
  ``vector`` for every single-launch suite entry at ``build_suite(1)``
  (``tests/test_torch_serve_parity_loop.py`` does ``loop``): bit for bit
  where the port's single launch is the reference's bit for bit, and
  within the entry's oracle ``tol`` where the two frameworks round a
  float32 result differently (``FLOAT_ROUNDING``) - there the port's rows
  are its own independent launches, bit for bit;
* ``_bucket`` and, under one deterministic request mix, the dispatch
  count, the occupancy histogram and the ``ServiceStats.to_json`` keys;
* the reference's disk round trip beside the port's departure on
  ``vector``: the same bits, and no record where nothing was compiled.

Both packages get the same inputs, made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core import cuda_suite as jsuite  # noqa: E402
from repro.serve import KernelService as JKernelService  # noqa: E402
from repro.serve import kernel_service as jks  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import api, cuda_suite  # noqa: E402
from repro_torch.serve import KernelService  # noqa: E402
from repro_torch.serve import kernel_service as ks  # noqa: E402

SINGLE = [e.name for e in cuda_suite.build_suite(1) if e.chain is None]
ROWS = 2

#: entries whose float32 results the port's single launch already rounds
#: differently from the reference's (XLA's fusion and contraction against
#: torch's operators): their batch rows are held to the entry's tol
#: against the reference, bit for bit against the port's own launches
FLOAT_ROUNDING = {
    "softmax_row": "exp and the row sums",
    "pixel_pipeline": "the three-stage float pipeline",
    "backprop_layer": "the squashing function and the weight update",
    "lud_diag": "the elimination's products",
    "lavamd": "exp and the force sums",
}


def _bits(v):
    return np.asarray(getattr(v, "value", v)).tobytes()


def batch_rows_against_the_reference(name: str, backend: str) -> None:
    port = next(e for e in cuda_suite.build_suite(1) if e.name == name)
    ref = next(e for e in jsuite.build_suite(1) if e.name == name)
    rng = np.random.default_rng(0)
    hosts = [port.make_args(rng) for _ in range(ROWS)]
    want = japi.launch_batch(
        ref.kernel, grid=ref.grid, block=ref.block,
        args_list=[{k: jnp.asarray(v) for k, v in h.items()} for h in hosts],
        dyn_shared=ref.dyn_shared, backend=backend)
    rows = [carry.from_reference(h, const=port.const, device="cpu")
            for h in hosts]
    got = api.launch_batch(port.kernel, grid=port.grid, block=port.block,
                           args_list=rows, dyn_shared=port.dyn_shared,
                           backend=backend)
    assert len(got) == ROWS
    exact = name not in FLOAT_ROUNDING
    solo = None if exact else [
        api.launch(port.kernel, grid=port.grid, block=port.block, args=a,
                   dyn_shared=port.dyn_shared, backend=backend)
        for a in rows]
    for i, (w, g) in enumerate(zip(want, got)):
        for k in port.kernel.writes:
            ref_v = np.asarray(w[k])
            got_v = g[k].numpy()
            assert got_v.dtype == ref_v.dtype and got_v.shape == ref_v.shape
            if exact:
                assert _bits(got_v) == _bits(ref_v), (name, backend, i, k)
            else:
                np.testing.assert_allclose(got_v, ref_v, rtol=port.tol,
                                           atol=port.tol)
                assert _bits(got_v) == _bits(solo[i][k].numpy())


@pytest.mark.parametrize("name", SINGLE)
def test_launch_batch_rows_are_the_references_on_vector(name):
    batch_rows_against_the_reference(name, "vector")


def test_every_single_launch_entry_is_covered():
    assert len(SINGLE) == 16
    assert set(FLOAT_ROUNDING) < set(SINGLE)
    assert SINGLE == [e.name for e in jsuite.build_suite(1)
                      if e.chain is None]


@pytest.mark.parametrize("cap", [1, 2, 4, 8, 16])
def test_bucket_is_the_references(cap):
    for n in range(1, 40):
        assert ks._bucket(n, cap) == jks._bucket(n, cap)


#: one deterministic request mix: (endpoint, count) in submission order
MIX = (("vecadd", 5), ("reverse", 3), ("vecadd", 2), ("scan_block", 1),
       ("reverse", 6))


def _serve(service, package_suite, to_args, backend):
    ents = {e.name: e for e in package_suite.build_suite(1)}
    svc = service(backend=backend, autostart=False, max_batch=4)
    try:
        for name in dict(MIX):
            svc.register_entry(ents[name])
        rng = np.random.default_rng(3)
        tickets = []
        for name, count in MIX:
            for _ in range(count):
                tickets.append((name, svc.submit(
                    name, to_args(ents[name].make_args(rng)))))
        svc.start()
        outs = [(name, t.result(timeout=300)) for name, t in tickets]
        return svc.stats(), outs, [t.batch_size for _, t in tickets]
    finally:
        svc.close()


@pytest.mark.parametrize("backend", ["vector", "loop"])
def test_service_dispatches_as_the_reference(backend):
    ref_stats, ref_outs, ref_sizes = _serve(
        JKernelService, jsuite,
        lambda h: {k: jnp.asarray(v) for k, v in h.items()}, backend)
    stats, outs, sizes = _serve(
        lambda **kw: KernelService(device="cpu", **kw), cuda_suite,
        lambda h: carry.from_reference(h, device="cpu"), backend)
    assert stats.dispatches == ref_stats.dispatches
    assert stats.batch_occupancy == ref_stats.batch_occupancy
    assert stats.batched_requests == ref_stats.batched_requests
    assert sizes == ref_sizes
    assert set(stats.to_json()) == set(ref_stats.to_json())
    assert set(stats.to_json()["kernels"]) == \
        set(ref_stats.to_json()["kernels"])
    assert (stats.completed, stats.failed) == (ref_stats.completed, 0)
    for (name, got), (_, want) in zip(outs, ref_outs):
        assert set(got) == set(want)
        for k in got:
            assert _bits(got[k]) == _bits(want[k]), (name, k)


def _vecadd_jax(n):
    from repro.core.kernel import KernelDef

    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        return st.set_glob(c=st.glob["c"].at[gid].set(
            st.glob["a"][gid] + st.glob["b"][gid]))
    return KernelDef("vecadd", (stage,), writes=("c",))


def test_disk_round_trip_beside_the_references(tmp_path):
    """The reference's round trip (its tests/test_graphs.py): a store, a
    'restart', a disk hit.  The port's ``vector`` launch compiles nothing,
    so it stores nothing and its restart misses again - with the same
    bits."""
    n = 128
    host = {"a": np.ones(n, np.float32), "b": np.ones(n, np.float32),
            "c": np.zeros(n, np.float32)}
    japi.cache_clear()
    japi.enable_disk_cache(str(tmp_path / "ref"))
    try:
        k = _vecadd_jax(n)
        args = {name: jnp.asarray(v) for name, v in host.items()}
        first = japi.launch(k, grid=1, block=n, args=args)
        assert japi.cache_stats().disk_stores == 1
        japi.cache_clear()
        again = japi.launch(k, grid=1, block=n, args=args)
        assert japi.cache_stats().disk_hits == 1
    finally:
        japi.disable_disk_cache()
        japi.cache_clear()

    api.cache_clear()
    api.enable_disk_cache(str(tmp_path / "port"))
    try:
        k = cuda_suite.make_vecadd(n)
        args = carry.from_reference(host, device="cpu")
        got = api.launch(k, grid=1, block=n, args=args)
        assert api.cache_stats().disk_stores == 0
        assert not (tmp_path / "port").exists()
        api.cache_clear()
        got_again = api.launch(k, grid=1, block=n, args=args)
        s = api.cache_stats()
        assert (s.disk_hits, s.misses, s.disk_stores) == (0, 1, 0)
        assert api.compiled(k, grid=1, block=n, args=args).source == "trace"
    finally:
        api.disable_disk_cache()
        api.cache_clear()
    for a, b in ((first, got), (again, got_again)):
        assert _bits(a["c"]) == _bits(b["c"].numpy())
        assert np.all(np.asarray(b["c"]) == torch.full((n,), 2.0).numpy())
