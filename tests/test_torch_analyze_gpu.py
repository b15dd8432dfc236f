"""kernelcheck and the barrier-fission optimizer on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; on a
machine with one they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_analyze_gpu.py``.  The file imports neither JAX nor the
reference package.  At ``build_suite(1)``'s sizes: the analyzer runs
every entry's stages on CUDA tensors, every report is clean and every
fusion artifact equals the one the CPU gives; an optimized ``vector`` run
on the card gives the base run's bits; and each entry on ``cuda`` under
``sanitize`` and ``optimize`` launches its hand-written kernel (the
derived kernel keeps it), as often as the plain run and with its bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import analyze, cuda_suite, lower_cuda, optimize
from repro_torch.core.memory import host_array

SUITE = cuda_suite.build_suite(scale=1)
#: the entries whose optimizer plan is not trivial (tests/test_torch_optimize.py)
OPTIMIZED = ("matmul_tiled", "softmax_row", "scan_block", "pixel_pipeline",
             "lud_diag", "lavamd")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(out: dict) -> dict[str, bytes]:
    return {k: host_array(getattr(v, "value", v)).tobytes()
            for k, v in out.items()}


def _counts() -> dict[str, int]:
    return {n: k.launches for n, k in lower_cuda.KERNELS.items()
            if k.launches}


def _zero():
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0


@pytest.mark.gpu
@pytest.mark.parametrize("entry", SUITE, ids=lambda e: e.name)
def test_analysis_on_the_card_is_clean_and_the_cpus(card, entry):
    _zero()
    reports = analyze.analyze_entry(entry, device=card)
    arts = analyze.fusion_entry(entry, device=card)
    assert not _counts()                 # the stages ran, not the kernels
    for report in reports:
        assert report.clean, "\n".join(str(f) for f in report.findings)
    assert arts == analyze.fusion_entry(entry, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPTIMIZED)
def test_optimized_vector_on_the_card_gives_the_base_bits(card, name):
    entry = next(e for e in SUITE if e.name == name)
    args = entry.make_args(np.random.default_rng(3))
    base, _ = cuda_suite.run_entry(entry, "vector", args=args, device=card,
                                   with_reference=False)
    opt, _ = cuda_suite.run_entry(entry, "vector", args=args, device=card,
                                  with_reference=False, optimize=True)
    assert _bits(opt) == _bits(base)
    derived = list(entry.kernel._optimize_derived.values())
    assert isinstance(derived[-1], optimize.OptimizedKernel)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", SUITE, ids=lambda e: e.name)
def test_sanitized_optimized_cuda_runs_the_hopper_kernel(card, entry,
                                                         monkeypatch):
    args = entry.make_args(np.random.default_rng(3))
    _zero()
    want, _ = cuda_suite.run_entry(entry, "cuda", args=args, device=card,
                                   with_reference=False)
    torch.cuda.synchronize()
    plain = _counts()
    mine = {s.kernel.name for s in cuda_suite.entry_steps(entry)}
    assert set(plain) == mine
    monkeypatch.setenv("CUPBOP_SANITIZE", "1")
    for _ in range(2):                   # analysed, then memoized
        _zero()
        got, _ = cuda_suite.run_entry(entry, "cuda", args=args, device=card,
                                      with_reference=False, optimize=True)
        torch.cuda.synchronize()
        assert _counts() == plain
        assert _bits(got) == _bits(want)
