"""The port's warp functions and atomics against ``repro.core.warp`` and
``repro.core.atomics``, bit for bit, on the same NumPy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import atomics as jatomics  # noqa: E402
from repro.core import warp as jwarp  # noqa: E402
from repro_torch.core import atomics, warp  # noqa: E402
from repro_torch.core.cuda_suite import OOB  # noqa: E402
from repro_torch.core.kernel import UnsupportedKernel  # noqa: E402

SEEDS = (0, 1, 2)


def _vals(seed, n=64, dtype=np.int32):
    r = np.random.default_rng(seed)
    if dtype == np.float32:
        return r.standard_normal(n).astype(np.float32)
    return r.integers(-100, 100, n).astype(dtype)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", (np.int32, np.float32))
@pytest.mark.parametrize("lane", (0, 5, 31, 37, -3))
def test_shfl_scalar_lane(seed, dtype, lane):
    v = _vals(seed, dtype=dtype)
    _eq(warp.shfl(torch.from_numpy(v), lane), jwarp.shfl(jnp.asarray(v), lane))


@pytest.mark.parametrize("seed", SEEDS)
def test_shfl_per_thread_lanes(seed):
    v = _vals(seed)
    src = np.random.default_rng(seed + 10).integers(-40, 80, 64)
    _eq(warp.shfl(torch.from_numpy(v), torch.from_numpy(src)),
        jwarp.shfl(jnp.asarray(v), jnp.asarray(src)))


@pytest.mark.parametrize("op", ("shfl_up", "shfl_down"))
@pytest.mark.parametrize("delta", (0, 1, 5, 16, 31, 40))
def test_shfl_shift_keeps_own_value_out_of_range(op, delta):
    v = _vals(3, dtype=np.float32)
    _eq(getattr(warp, op)(torch.from_numpy(v), delta),
        getattr(jwarp, op)(jnp.asarray(v), delta))


@pytest.mark.parametrize("mask", (0, 1, 7, 16, 31, 32, 45))
def test_shfl_xor_scalar_mask(mask):
    v = _vals(4)
    _eq(warp.shfl_xor(torch.from_numpy(v), mask),
        jwarp.shfl_xor(jnp.asarray(v), mask))


@pytest.mark.parametrize("seed", SEEDS)
def test_shfl_xor_per_thread_mask(seed):
    v = _vals(seed)
    m = np.random.default_rng(seed + 20).integers(0, 64, 64)
    _eq(warp.shfl_xor(torch.from_numpy(v), torch.from_numpy(m)),
        jwarp.shfl_xor(jnp.asarray(v), jnp.asarray(m)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("density", (0.0, 0.5, 1.0))
def test_votes_ballot_and_block_count(seed, density):
    p = np.random.default_rng(seed).random(64) < density
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    _eq(warp.vote_all(tp), jwarp.vote_all(jp))
    _eq(warp.vote_any(tp), jwarp.vote_any(jp))
    _eq(warp.ballot(tp), np.asarray(jwarp.ballot(jp)).astype(np.int64))
    _eq(warp.syncthreads_count(tp, 64), jwarp.syncthreads_count(jp, 64))
    assert warp.syncthreads_count(tp, 64).dtype == torch.int32


def test_syncthreads_count_needs_the_whole_block():
    with pytest.raises(UnsupportedKernel):
        warp.syncthreads_count(torch.ones(32, dtype=torch.bool), 64)
    with pytest.raises(UnsupportedKernel):
        warp.shfl(torch.ones(30), 0)


@pytest.mark.parametrize("op", ("add", "max", "min"))
@pytest.mark.parametrize("dtype", (np.int32, np.float32))
def test_warp_reduce(op, dtype):
    v = _vals(5, dtype=dtype)
    got = warp.reduce(torch.from_numpy(v), op)
    want = jwarp.reduce(jnp.asarray(v), op)
    if dtype == np.float32 and op == "add":
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)     # summation order differs
    else:
        _eq(got, want)


def _atomic_case(seed, n=8, k=24):
    r = np.random.default_rng(seed)
    arr = r.integers(0, 3, n).astype(np.int32)
    idx = r.integers(-n - 2, n + 3, k)
    idx[r.random(k) < 0.15] = OOB
    val = r.integers(-5, 6, k).astype(np.int32)
    return arr, idx, val


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("op", ("atomic_add", "atomic_max", "atomic_min"))
def test_scatter_atomics_drop_negative_and_oob(seed, op):
    arr, idx, val = _atomic_case(seed)
    got = getattr(atomics, op)(torch.from_numpy(arr), torch.from_numpy(idx),
                               torch.from_numpy(val))
    want = getattr(jatomics, op)(jnp.asarray(arr), jnp.asarray(idx),
                                 jnp.asarray(val))
    _eq(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_atomic_cas_serialised_in_thread_order(seed):
    arr, idx, _ = _atomic_case(seed)
    cmp = np.random.default_rng(seed).integers(0, 3, idx.size)
    val = np.arange(idx.size, dtype=np.int32) + 10
    got, old = atomics.atomic_cas(torch.from_numpy(arr), torch.from_numpy(idx),
                                  torch.from_numpy(cmp), torch.from_numpy(val))
    want, jold = jatomics.atomic_cas(jnp.asarray(arr), jnp.asarray(idx),
                                     jnp.asarray(cmp), jnp.asarray(val))
    _eq(got, want)
    _eq(old, jold)


@pytest.mark.parametrize("seed", SEEDS)
def test_atomic_exch_last_duplicate_survives(seed):
    arr, idx, val = _atomic_case(seed)
    got, old = atomics.atomic_exch(torch.from_numpy(arr),
                                   torch.from_numpy(idx), torch.from_numpy(val))
    want, jold = jatomics.atomic_exch(jnp.asarray(arr), jnp.asarray(idx),
                                      jnp.asarray(val))
    _eq(got, want)
    _eq(old, jold)


@pytest.mark.parametrize("seed", SEEDS)
def test_atomic_cas_first(seed):
    arr, idx, val = _atomic_case(seed)
    cmp = np.random.default_rng(seed + 1).integers(0, 3, idx.size)
    got = atomics.atomic_cas_first(torch.from_numpy(arr),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(cmp),
                                   torch.from_numpy(val))
    want = jatomics.atomic_cas_first(jnp.asarray(arr), jnp.asarray(idx),
                                     jnp.asarray(cmp), jnp.asarray(val))
    _eq(got, want)
