"""Table II across the two packages: ``api.supported`` / ``api.coverage``
against the reference's, on the CPU.

Every kernel of ``build_suite(1)`` (each step of a chain) is probed with
the port's ``coverage`` and the reference's ``supported`` on the seven
backends both registries have (``cuda`` matched to ``pallas``), on the
entry's inputs and block.  The probe runs one block (``grid=1``) so that
the loop lowerings stay cheap, except for the two kernels whose wrappers
take only their whole grid (one thread a node, one block a cluster); the
loop family decides from the kernel and the block alone.  The ``cuda``
column's base points against ``pallas`` are in
``tests/test_torch_conformance_parity.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import api as japi
from repro.core import cuda_suite as jsuite
from repro.core.memory import ConstArray as JConstArray
torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import api, backends, cuda_suite  # noqa: E402
from repro_torch.core.kernel import UnsupportedKernel  # noqa: E402
#: the port's backend -> the reference's backend in the same column
COLUMNS = {"loop": "loop", "loop_nowarp": "loop_nowarp", "naive": "naive",
           "vector": "vector", "cuda": "pallas", "shard": "shard",
           "shard_vector": "shard_vector"}
#: kernels whose cuda wrappers take only the entry's whole grid
WHOLE_GRID = ("bfs_frontier", "kmeans_update")

PORT = {e.name: e for e in cuda_suite.build_suite(1)}
REF = {e.name: e for e in jsuite.build_suite(1)}
PROBES = [(name, i) for name, e in PORT.items()
          for i in range(len(cuda_suite.entry_steps(e)))]


def _ref_steps(entry) -> list[tuple]:
    if entry.chain is None:
        return [(entry.kernel, entry.grid, entry.block, entry.dyn_shared)]
    return [(s.kernel, s.grid, s.block, s.dyn_shared)
            for s in entry.chain.steps]


@pytest.mark.parametrize("probe", PROBES,
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_coverage_row_agrees_with_the_reference(probe):
    name, i = probe
    entry, jentry = PORT[name], REF[name]
    step = cuda_suite.entry_steps(entry)[i]
    jkernel, jgrid, jblock, jdyn = _ref_steps(jentry)[i]
    assert (step.kernel.name, step.grid, step.block, step.dyn_shared) == (
        jkernel.name, jgrid, jblock, jdyn)
    grid = step.grid if step.kernel.name in WHOLE_GRID else 1
    args = entry.make_args(np.random.default_rng(0))
    bufs = carry.from_reference(args, const=entry.const, device="cpu")
    jbufs = {k: JConstArray(jnp.asarray(v)) if k in jentry.const
             else jnp.asarray(v) for k, v in args.items()}
    row = api.coverage(step.kernel, grid=grid, block=step.block, args=bufs,
                       dyn_shared=step.dyn_shared)
    assert list(row) == list(backends.backend_names()) == list(COLUMNS)
    want = {b: japi.supported(jkernel, jb, grid=grid, block=jblock,
                              args=jbufs, dyn_shared=jdyn)
            for b, jb in COLUMNS.items()}
    assert row == want


def test_supported_refuses_what_the_reference_refuses():
    """An unknown backend raises, missing args raise, and only
    UnsupportedKernel reads as unsupported - in both packages."""
    kernel = cuda_suite.make_vecadd(64)
    bufs = carry.from_reference(
        {k: np.ones(64, np.float32) for k in "abc"}, device="cpu")
    with pytest.raises(backends.UnknownBackend):
        api.supported(kernel, "tpu_v7", args=bufs)
    with pytest.raises(ValueError, match="representative args"):
        api.supported(kernel, "vector")
    with pytest.raises(ValueError, match="representative args"):
        japi.supported(jsuite.make_vecadd(64), "vector")
    # a wrong buffer shape is no Table-II gap: the wrapper's ValueError
    # propagates instead of reading as "unsupported"
    short = {**bufs, "c": bufs["c"][:32]}
    with pytest.raises(ValueError, match="expected"):
        api.supported(kernel, "cuda", grid=1, block=64, args=short)
    assert not api.supported(cuda_suite.make_reduce_warp(128, 64),
                             "loop_nowarp", grid=2, block=64,
                             args=carry.from_reference(
                                 {"x": np.ones(128, np.float32),
                                  "out": np.zeros(2, np.float32)},
                                 device="cpu"))


def test_coverage_row_spans_the_registry_and_follows_it():
    """A backend registered later gets a column; unregistered, it goes."""
    from repro_torch.core import lower_vector

    def echo(kernel, *, grid, block, glob, grain, dyn_shared, interpret):
        return lower_vector.run(kernel, grid=grid, block=block, glob=glob,
                                grain=grain, dyn_shared=dyn_shared)

    def refuse(kernel, block):
        raise UnsupportedKernel("refuses everything")

    kernel = cuda_suite.make_reduce_warp(128, 64)
    bufs = carry.from_reference({"x": np.ones(128, np.float32),
                                 "out": np.zeros(2, np.float32)},
                                device="cpu")
    backends.register_backend("echo", echo, {"barrier", "warp", "dim3"})
    backends.register_backend("refuser", echo, check=refuse)
    try:
        row = api.coverage(kernel, grid=2, block=64, args=bufs)
        assert list(row) == [*COLUMNS, "echo", "refuser"]
        assert row == {"loop": True, "loop_nowarp": False, "naive": False,
                       "vector": True, "cuda": True, "shard": True,
                       "shard_vector": True, "echo": True,
                       "refuser": False}
    finally:
        backends.unregister_backend("echo")
        backends.unregister_backend("refuser")
    assert list(api.coverage(kernel, grid=2, block=64, args=bufs)) == list(
        COLUMNS)
