"""The port's index rules against JAX's own gathers and ``.at[]`` scatters.

Negative, past-the-end and duplicate indices, and the suite's ``OOB``
sentinel, go through :mod:`repro_torch.core.index` and through ``jnp`` on
the same NumPy inputs; the results must be bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import index  # noqa: E402
from repro_torch.core.cuda_suite import OOB  # noqa: E402

SET = settings(max_examples=40, deadline=None, database=None)
OPS = ("set", "add", "max", "min")


def _idx(size):
    """Indices around an axis of ``size``: negative past ``-size``, past
    the end, and the suite's OOB sentinel."""
    return st.one_of(st.integers(-2 * size - 1, 2 * size + 1), st.just(OOB))


@st.composite
def gather_1d(draw):
    size = draw(st.integers(1, 8))
    x = np.asarray(draw(st.lists(st.integers(-50, 50), min_size=size,
                                 max_size=size)), np.int32)
    idx = np.asarray(draw(st.lists(_idx(size), min_size=1, max_size=12)),
                     np.int64)
    return x, idx


@st.composite
def scatter_1d(draw):
    x, idx = draw(gather_1d())
    # few distinct targets, so duplicates are common
    if draw(st.booleans()):
        idx = idx % max(1, len(x) // 2)
    val = np.asarray(draw(st.lists(st.integers(-50, 50), min_size=len(idx),
                                   max_size=len(idx))), np.int32)
    return x, idx, val


@st.composite
def scatter_2d(draw):
    r, c = draw(st.integers(1, 5)), draw(st.integers(1, 5))
    x = np.asarray(draw(st.lists(st.integers(-50, 50), min_size=r * c,
                                 max_size=r * c)), np.int32).reshape(r, c)
    k = draw(st.integers(1, 10))
    i = np.asarray(draw(st.lists(_idx(r), min_size=k, max_size=k)), np.int64)
    j = np.asarray(draw(st.lists(_idx(c), min_size=k, max_size=k)), np.int64)
    val = np.asarray(draw(st.lists(st.integers(-50, 50), min_size=k,
                                   max_size=k)), np.int32)
    return x, i, j, val


def _jax_scatter(x, idx, val, op):
    return np.asarray(getattr(jnp.asarray(x).at[idx], op)(
        jnp.asarray(val), mode="drop"))


@SET
@given(case=gather_1d())
def test_gather_wraps_once_then_clamps(case):
    x, idx = case
    got = index.take(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(x)[idx]))


@SET
@given(case=scatter_2d())
def test_gather_tuple_index(case):
    x, i, j, _ = case
    got = index.take(torch.from_numpy(x), torch.from_numpy(i),
                     torch.from_numpy(j))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(x)[i, j]))


@pytest.mark.parametrize("op", OPS)
@SET
@given(case=scatter_1d())
def test_scatter_drop_duplicates(op, case):
    x, idx, val = case
    got = index.put(torch.from_numpy(x), torch.from_numpy(idx),
                    torch.from_numpy(val), op)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_scatter(x, jnp.asarray(idx), val, op))


@pytest.mark.parametrize("op", OPS)
@SET
@given(case=scatter_2d())
def test_scatter_tuple_index(op, case):
    x, i, j, val = case
    got = index.put(torch.from_numpy(x),
                    (torch.from_numpy(i), torch.from_numpy(j)),
                    torch.from_numpy(val), op)
    want = _jax_scatter(x, (jnp.asarray(i), jnp.asarray(j)), val, op)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_scalar_value_broadcasts_and_leaves_input():
    x = torch.zeros(4, dtype=torch.int32)
    got = index.put(x, torch.tensor([1, OOB, -1, 1]), 7)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.zeros(4, jnp.int32)
                                .at[jnp.asarray([1, OOB, -1, 1])]
                                .set(7, mode="drop")))
    assert int(x.abs().sum()) == 0           # functional, like .at[]


def test_put_rejects_unknown_op_and_extra_indices():
    x = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="unknown scatter op"):
        index.put(x, 0, 1.0, "mul")
    with pytest.raises(IndexError):
        index.put(x, (0, 0, 0), 1.0)
    with pytest.raises(IndexError):
        index.take(x, 0, 0, 0)
