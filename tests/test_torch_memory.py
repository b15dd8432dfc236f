"""The port's host copies and ``cuda_memcpy_async`` against the JAX
package's, on the CPU.

bfloat16 (``ml_dtypes``' type, which ``torch.from_numpy`` refuses) crosses
every host copy as its 16-bit patterns: h2d, d2h, a handle read as an
array, malloc then d2h, and ``cuda_memcpy_async`` both ways - each bit for
bit against the reference's own ``cuda_memcpy_h2d``/``cuda_memcpy_d2h``.
``cuda_memcpy_async`` takes the reference's three operand forms (named
heap buffers on a stream, ``DeviceBuffer`` handles, NumPy host arrays)
with its checks: liveness, geometry, ``__constant__`` destinations, a
stream for named copies, no handle copies during capture.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import Stream as JStream
from repro.core import cuda_memcpy_async as jmemcpy_async
from repro.core import cuda_memcpy_d2h as jmemcpy_d2h
from repro.core import cuda_memcpy_h2d as jmemcpy_h2d
from repro_torch.core import (
    CudaError,
    GraphError,
    Stream,
    cuda_free,
    cuda_malloc,
    cuda_memcpy_async,
    cuda_memcpy_d2h,
    cuda_memcpy_h2d,
)
from repro_torch.core.memory import (
    UnsupportedSpace,
    cuda_memcpy_to_symbol,
    host_array,
    host_tensor,
)

BF16 = ml_dtypes.bfloat16


def _bf16(shape=(3, 5)):
    # every class of value: normals, subnormals, signed zeros, inf, nan
    vals = np.random.default_rng(11).standard_normal(shape) * 8
    arr = vals.astype(np.float32).astype(BF16)
    flat = arr.reshape(-1)
    flat[:5] = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40],
                        np.float32).astype(BF16)
    flat[5] = BF16(np.nan)
    return arr


def _bits(a):
    a = np.asarray(a)
    assert a.dtype == BF16, a.dtype
    return a.view(np.uint16)


def test_bfloat16_h2d_and_d2h_match_the_reference_bit_for_bit():
    host = _bf16()
    buf = cuda_memcpy_h2d(host, device="cpu")
    assert buf.dtype == torch.bfloat16 and tuple(buf.shape) == host.shape
    want = jmemcpy_d2h(jmemcpy_h2d(host))
    np.testing.assert_array_equal(_bits(cuda_memcpy_d2h(buf)), _bits(want))
    np.testing.assert_array_equal(_bits(np.asarray(buf)), _bits(want))
    np.testing.assert_array_equal(_bits(host_array(host_tensor(host))),
                                  _bits(host))


def test_bfloat16_malloc_then_d2h_matches_the_reference():
    buf = cuda_malloc((4, 2), torch.bfloat16, device="cpu")
    got = cuda_memcpy_d2h(buf)
    want = jmemcpy_d2h(jmemcpy_h2d(np.zeros((4, 2), BF16)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert cuda_memcpy_h2d(_bf16((4, 2)), buf) is buf
    np.testing.assert_array_equal(_bits(cuda_memcpy_d2h(buf)),
                                  _bits(_bf16((4, 2))))


def test_bfloat16_memcpy_async_round_trip_matches_the_reference():
    host = _bf16()
    buf = cuda_malloc(host.shape, torch.bfloat16, device="cpu")
    assert cuda_memcpy_async(buf, host) is buf                   # h2d
    out = np.empty(host.shape, BF16)
    assert cuda_memcpy_async(out, buf) is out                    # d2h
    jbuf = jmemcpy_h2d(np.zeros(host.shape, BF16))
    jmemcpy_async(jbuf, host)
    np.testing.assert_array_equal(_bits(out), _bits(jmemcpy_d2h(jbuf)))
    np.testing.assert_array_equal(_bits(cuda_memcpy_async(None, buf)),
                                  _bits(host))
    s = Stream({"x": torch.zeros(host.shape, dtype=torch.bfloat16)})
    cuda_memcpy_async("x", host, stream=s)                       # named h2d
    np.testing.assert_array_equal(_bits(s.memcpy_d2h("x")), _bits(host))


def test_host_copies_never_share_memory_with_the_caller():
    host = np.arange(4, dtype=np.float32)
    buf = cuda_memcpy_h2d(host, device="cpu")
    host[0] = 99.0
    assert float(buf.value[0]) == 0.0
    back = cuda_memcpy_d2h(buf)
    back[1] = 99.0
    assert float(buf.value[1]) == 1.0


def test_memcpy_async_h2d_d2d_d2h_roundtrip():
    host = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = cuda_malloc((3, 4), torch.float32, device="cpu")
    storage = a.value
    assert cuda_memcpy_async(a, host) is a                   # h2d
    assert a.value is storage                                # in its storage
    b = cuda_malloc((3, 4), torch.float32, device="cpu")
    assert cuda_memcpy_async(b, a) is b                      # d2d
    assert b.value is not a.value
    out = np.empty((3, 4), np.float32)
    assert cuda_memcpy_async(out, b) is out                  # d2h in place
    np.testing.assert_array_equal(out, host)
    np.testing.assert_array_equal(cuda_memcpy_async(None, b), host)


def test_memcpy_async_with_freed_operands_raises():
    live = cuda_malloc((8,), torch.float32, device="cpu")
    dead = cuda_malloc((8,), torch.float32, device="cpu")
    cuda_free(dead)
    with pytest.raises(CudaError, match="cudaErrorInvalidValue"):
        cuda_memcpy_async(dead, np.zeros(8, np.float32))
    with pytest.raises(CudaError, match="cudaErrorInvalidValue"):
        cuda_memcpy_async(live, dead)
    with pytest.raises(CudaError, match="cudaErrorInvalidValue"):
        cuda_memcpy_async(None, dead)


def test_memcpy_async_geometry_mismatch_raises():
    a = cuda_malloc((8,), torch.float32, device="cpu")
    with pytest.raises(CudaError, match="geometry mismatch"):
        cuda_memcpy_async(a, np.zeros(9, np.float32))
    with pytest.raises(CudaError, match="geometry mismatch"):
        cuda_memcpy_async(a, cuda_malloc((8,), torch.int32, device="cpu"))
    with pytest.raises(CudaError, match="geometry mismatch"):
        cuda_memcpy_async(np.empty(9, np.float32), a)


def test_memcpy_async_into_const_raises_and_from_const_reads():
    sym = cuda_memcpy_to_symbol(np.arange(4, dtype=np.float32), device="cpu")
    with pytest.raises(UnsupportedSpace, match="read-only"):
        cuda_memcpy_async(sym, np.ones(4, np.float32))
    dst = cuda_malloc((4,), torch.float32, device="cpu")
    cuda_memcpy_async(dst, sym)
    np.testing.assert_array_equal(np.asarray(dst), np.arange(4))


def test_memcpy_async_operand_kinds_it_cannot_infer_raise():
    with pytest.raises(CudaError, match="stream="):
        cuda_memcpy_async("x", np.zeros(4, np.float32))
    with pytest.raises(CudaError, match="cannot infer copy kind"):
        cuda_memcpy_async(np.zeros(4), np.zeros(4))


def test_memcpy_async_named_heap_forms():
    s = Stream({"x": torch.arange(8, dtype=torch.float32),
                "y": torch.zeros(8)})
    js = JStream({"x": jnp.arange(8, dtype=jnp.float32),
                  "y": jnp.zeros(8, jnp.float32)})
    for stream, copy, h2d in ((s, cuda_memcpy_async,
                               lambda a: cuda_memcpy_h2d(a, device="cpu")),
                              (js, jmemcpy_async, jmemcpy_h2d)):
        copy("y", "x", stream=stream)                        # named d2d
        np.testing.assert_array_equal(stream.memcpy_d2h("y"), np.arange(8))
        copy("x", np.full(8, 7.0, np.float32), stream=stream)   # h2d
        got = np.empty(8, np.float32)
        assert copy(got, "x", stream=stream) is got          # named d2h
        np.testing.assert_array_equal(got, 7.0)
        buf = h2d(np.full(8, 3.0, np.float32))
        copy("y", buf, stream=stream)                        # handle -> heap
        np.testing.assert_array_equal(stream.memcpy_d2h("y"), 3.0)
    assert (s.stats.syncs, s.stats.barriers_inserted) == \
        (js.stats.syncs, js.stats.barriers_inserted)


def test_captured_copies_are_checked_at_enqueue():
    s = Stream({"x": torch.zeros(8), "y": torch.zeros(9)})
    a = cuda_malloc((8,), torch.float32, device="cpu")
    s.begin_capture()
    with pytest.raises(CudaError, match="geometry mismatch"):
        s.memcpy_d2d("x", "y")                       # named source
    with pytest.raises(CudaError, match="geometry mismatch"):
        s.memcpy_d2d("x", torch.zeros(9))            # tensor source
    with pytest.raises(GraphError, match="named heap buffer"):
        cuda_memcpy_async(a, np.ones(8, np.float32), stream=s)
    with pytest.raises(GraphError, match="host-visible"):
        cuda_memcpy_async(np.empty(8, np.float32), "x", stream=s)
    assert s.end_capture().nodes == []
