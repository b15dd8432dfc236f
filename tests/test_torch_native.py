"""The ``cuda`` backend's build, and its kernels on the card.

The build tests run anywhere.  The tests marked ``gpu`` need a CUDA
device and ``nvcc``; they skip elsewhere, and on a machine with a card
they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_native.py``.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch import carry
from repro_torch.core import _native, cuda_suite, lower_cuda
from repro_torch.core.dim3 import Dim3

NAMES = ("bfs_frontier", "pathfinder", "needle_nw", "hotspot")


def test_build_key_covers_every_source_and_flag(monkeypatch, tmp_path):
    before = _native.source_hash()
    for src in _native.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    assert _native.source_hash() == before
    (tmp_path / "needle_nw.cu").write_text(
        (tmp_path / "needle_nw.cu").read_text() + "\n// edited\n")
    edited = _native.source_hash()
    assert edited != before
    monkeypatch.setattr(_native, "COMPILE_FLAGS",
                        (*_native.COMPILE_FLAGS, "-lineinfo"))
    assert _native.source_hash() not in (before, edited)


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present here")
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "TOOLKIT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build()
    assert not (tmp_path / "build").exists()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(name):
    entry = getattr(cuda_suite, f"entry_{name}")(
        **({"n": 1024, "deg": 6} if name == "bfs_frontier" else {}))
    args = entry.make_args(np.random.default_rng(42))
    if name == "bfs_frontier":
        dist = cuda_suite.bfs_levels(args["edges"], 1024)
        level = int(np.bincount(dist[dist >= 0]).argmax())
        args.update(frontier=(dist == level).astype(np.int32),
                    visited=((dist >= 0) & (dist <= level)).astype(np.int32),
                    level=np.full(1, level, np.int32))
    return entry, args


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_its_plain_version_on_the_card(card, name):
    entry, args = _state(name)
    step = entry.chain.steps[0]
    kern = lower_cuda.KERNELS[name]
    params = dict(step.kernel.native.params)
    bufs = carry.from_reference(args, device=card)
    before = kern.launches
    got = kern(bufs, grid=step.grid, block=step.block, **params)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(bufs, Dim3.of(step.grid), Dim3.of(step.block),
                      **params)
    for k in kern.writes:
        if name == "hotspot":      # nvcc contracts to FMAs: entry tol
            torch.testing.assert_close(got[k], want[k], rtol=1e-4,
                                       atol=1e-4)
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_run_entry_on_the_default_device(card, name):
    entry = getattr(cuda_suite, f"entry_{name}")()
    out, want = cuda_suite.run_entry(entry, "cuda")
    for k, v in want.items():
        assert out[k].device.type == "cuda"
        np.testing.assert_allclose(out[k].cpu().numpy(), v, rtol=entry.tol,
                                   atol=entry.tol)
