"""The port's x64 switch against JAX's, on the CPU.

The reference computes in 32 bits unless JAX's 64-bit types are on; its
conformance matrix turns them on for its float64 cells
(``repro.core.conformance``, ``DTYPE_TOL["f64"] = 1e-12``).  The port
mirrors the switch with :func:`repro_torch.enable_x64`.  The cells here
are the reference's own float64 cases (vecadd, reduce_shared,
pathfinder), built by ``repro.core.conformance`` and run by the
reference's ``loop`` backend, against the same builders in the port under
``vector`` and ``loop``, on the same inputs:

* switch on (JAX's ``enable_x64`` on the reference's side): every float
  buffer is float64 and within 1e-12 of the reference's;
* switch off (JAX's default): every buffer is float32, bit for bit the
  reference's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import conformance as jconf
from repro.core import cuda_suite as jsuite
from repro_torch import carry
from repro_torch.core import cuda_suite
from repro_torch.core.kernel import UnsupportedKernel
from repro_torch.core.memory import cuda_malloc, cuda_memcpy_h2d
from repro_torch.x64 import canonical_dtype, x64_enabled

#: JAX's switch: ``jax.enable_x64`` in newer releases (a config state,
#: which refuses ``bool()``), ``jax.experimental.enable_x64`` in older
JAX_X64 = getattr(jax, "enable_x64", None)
if JAX_X64 is None:
    JAX_X64 = jax.experimental.enable_x64

F64_TOL = 1e-12           # the reference's DTYPE_TOL["f64"]
NAMES = ("vecadd", "reduce_shared", "pathfinder")


def _port_entry(name: str) -> cuda_suite.SuiteEntry:
    """The port's counterpart of the reference's f64 conformance case."""
    if name == "pathfinder":
        return cuda_suite.entry_pathfinder(dtype=torch.float64)
    n, block = 1024, 128
    if name == "vecadd":
        kernel = cuda_suite.make_vecadd(n)
    else:
        kernel = cuda_suite.make_reduce_shared(n, block, dtype=torch.float64)
    return cuda_suite.SuiteEntry(name, (), kernel, n // block, block, None,
                                 make_args=None, reference=None)


@functools.cache
def _reference(name: str, x64: bool):
    """The reference's f64 cell (its ``loop`` backend): its inputs, drawn
    from ``default_rng(42)``, and its output buffers, with JAX's 64-bit
    types on or off."""
    case = {c.name: c for c in jconf.build_cases()}[name]
    entry = case.make("f64")
    args = entry.make_args(np.random.default_rng(42))
    with JAX_X64(x64):
        out, _ = jsuite.run_entry(entry, "loop", args=args,
                                  with_reference=False)
        out = {k: np.asarray(v) for k, v in out.items()}
    return args, out


def _port(name: str, backend: str, x64: bool) -> dict:
    args, _ = _reference(name, x64)
    with repro_torch.enable_x64(x64):
        out, _ = cuda_suite.run_entry(_port_entry(name), backend, args=args,
                                      with_reference=False, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("backend", ("vector", "loop"))
@pytest.mark.parametrize("name", NAMES)
def test_f64_cells_compute_in_float64_under_the_switch(name, backend):
    _, want = _reference(name, True)
    got = _port(name, backend, True)
    assert set(got) == set(want)
    floats = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        if w.dtype.kind == "f":
            floats += 1
            assert w.dtype == np.float64, k
            np.testing.assert_allclose(got[k], w, rtol=F64_TOL, atol=F64_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert floats


@pytest.mark.parametrize("backend", ("vector", "loop"))
@pytest.mark.parametrize("name", NAMES)
def test_f64_cells_narrow_to_float32_with_the_switch_off(name, backend):
    # the same builders and inputs: float32 throughout, the shared arrays
    # too, and bit for bit the reference's cells with x64 off
    _, want = _reference(name, False)
    got = _port(name, backend, False)
    assert set(got) == set(want)
    for k, w in want.items():
        assert w.dtype in (np.float32, np.int32), k
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      w.view(np.int32), err_msg=k)


def test_switch_off_by_default_and_restored_after_an_exception():
    assert not x64_enabled()
    with pytest.raises(RuntimeError, match="inside"):
        with repro_torch.enable_x64():
            assert x64_enabled()
            raise RuntimeError("inside the switch")
    assert not x64_enabled()
    with repro_torch.enable_x64():
        with pytest.raises(ValueError):
            with repro_torch.enable_x64(False):
                assert not x64_enabled()
                raise ValueError
        assert x64_enabled()
    assert not x64_enabled()


@pytest.mark.parametrize("x64", (False, True))
def test_every_maker_of_reference_arrays_follows_the_switch(x64):
    # carry, cudaMalloc, host copies and a kernel's shared arrays narrow
    # float64 and int64 as jnp.asarray / jnp.zeros do, unless it is on
    f, i = (torch.float64, torch.int64) if x64 else (torch.float32,
                                                     torch.int32)
    args = {"a": np.arange(4, dtype=np.int64), "b": np.ones((2, 2)),
            "c": np.zeros(3, np.float32), "d": np.ones(2, np.int32)}
    kernel = cuda_suite.make_reduce_shared(256, 128, dtype=torch.float64)
    with repro_torch.enable_x64(x64):
        out = carry.from_reference(args, device="cpu")
        assert (out["a"].dtype, out["b"].dtype) == (i, f)
        assert (out["c"].dtype, out["d"].dtype) == (torch.float32,
                                                    torch.int32)
        np.testing.assert_array_equal(out["a"].numpy(), args["a"])
        assert cuda_malloc((2,), torch.float64, device="cpu").dtype == f
        assert cuda_memcpy_h2d(np.ones(2), device="cpu").dtype == f
        assert kernel.init_shared(None, "cpu")["s"].dtype == f
        assert canonical_dtype(np.int64) == (np.int64 if x64 else np.int32)
        assert canonical_dtype(torch.bfloat16) == torch.bfloat16


#: why the cuda backend refuses each f64 cell: the wrapper's dtype check,
#: or no kernel at all (pathfinder's is built for int32 only)
REFUSALS = {"vecadd": "float64", "reduce_shared": "float64",
            "pathfinder": "no hand-written CUDA body"}


@pytest.mark.parametrize("name", NAMES)
def test_cuda_backend_refuses_float64_cells(name):
    # a Table-II "unsupport" cell, never a launch on narrowed data
    args, _ = _reference(name, True)
    with repro_torch.enable_x64(), \
            pytest.raises(UnsupportedKernel, match=REFUSALS[name]):
        cuda_suite.run_entry(_port_entry(name), "cuda", args=args,
                             with_reference=False, device="cpu")


#: the 64-bit types JAX narrows with its switch off, and what to
WIDE = {np.float64: "float32", np.int64: "int32", np.uint64: "uint32",
        np.complex128: "complex64"}


@pytest.mark.parametrize("x64", (False, True))
@pytest.mark.parametrize("wide", tuple(WIDE), ids=lambda t: t.__name__)
def test_carry_malloc_and_h2d_narrow_as_jax_does(wide, x64):
    from repro.core import memory as jmemory
    arr = (np.arange(6) + 1).astype(wide).reshape(2, 3)
    with JAX_X64(x64):
        want = {"carry": jax.numpy.asarray(arr).dtype,
                "malloc": jmemory.cuda_malloc((2, 3), wide).dtype,
                "h2d": jmemory.cuda_memcpy_h2d(arr).dtype}
    with repro_torch.enable_x64(x64):
        got = {"carry": carry.from_reference({"a": arr},
                                             device="cpu")["a"].dtype,
               "malloc": cuda_malloc((2, 3), wide, device="cpu").dtype,
               "h2d": cuda_memcpy_h2d(arr, device="cpu").dtype}
        torch_wide = canonical_dtype(torch.from_numpy(arr).dtype)
    for k, dt in got.items():
        assert str(dt).removeprefix("torch.") == np.dtype(want[k]).name, k
    assert str(torch_wide).removeprefix("torch.") == \
        (np.dtype(wide).name if x64 else WIDE[wide])
    with repro_torch.enable_x64(x64):
        back = cuda_memcpy_h2d(arr, device="cpu").value
    np.testing.assert_array_equal(back.numpy(), arr)
