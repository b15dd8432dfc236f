"""The frontend's translated twins on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; on a
machine with one they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_frontend_gpu.py``.  The file imports neither JAX nor the
reference package.  Each corpus twin runs on ``vector`` with its buffers
on the card, bit for bit the hand-written entry on ``cuda``, whose kernel
must have launched (its ``launches`` count, which only a launch on the
card adds to); the ``cuda`` backend refuses a translated kernel and
launches nothing; the gate runs on the card.
"""
import pytest
import torch

from repro_torch.core import cuda_suite, lower_cuda
from repro_torch.core.kernel import UnsupportedKernel
from repro_torch.core.memory import host_array
from repro_torch.frontend.__main__ import main as gate_main
from repro_torch.frontend.suite import CORPUS, _bases, frontend_twin


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _zero():
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0


def _counts() -> dict[str, int]:
    return {n: k.launches for n, k in lower_cuda.KERNELS.items() if k.launches}


def _bits(out: dict) -> dict[str, bytes]:
    return {k: host_array(getattr(v, "value", v)).tobytes()
            for k, v in out.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CORPUS)
def test_twin_on_vector_is_the_hopper_kernel_bit_for_bit(card, name):
    base = _bases()[name]
    _zero()
    want, _ = cuda_suite.run_entry(base, "cuda", device=card,
                                   with_reference=False)
    torch.cuda.synchronize()
    mine = {s.kernel.name for s in cuda_suite.entry_steps(base)}
    counts = _counts()
    assert set(counts) == mine and min(counts.values()) >= 1, counts
    _zero()
    got, _ = cuda_suite.run_entry(frontend_twin(name), "vector", device=card,
                                  with_reference=False)
    assert not _counts()
    assert all(getattr(v, "value", v).device.type == "cuda"
               for v in got.values())
    assert _bits(got) == _bits(want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CORPUS)
def test_cuda_refuses_a_translated_kernel_and_launches_nothing(card, name):
    _zero()
    with pytest.raises(UnsupportedKernel, match="no hand-written CUDA"):
        cuda_suite.run_entry(frontend_twin(name), "cuda", device=card,
                             with_reference=False)
    assert not _counts()


@pytest.mark.gpu
def test_gate_passes_on_the_card_and_its_injection_fails(card, capsys):
    assert gate_main(["--backends", "vector", "--device", "cuda"]) == 0
    assert "frontend gate: passed (6 kernels x 1 backends" in (
        capsys.readouterr().out)
    assert gate_main(["--backends", "vector", "--kernels", "needle_nw",
                      "--inject", "--device", "cuda"]) == 1
    assert "frontend gate: FAILED" in capsys.readouterr().err
