"""The barrier-fission optimizer on the seven chains' ``loop`` runs.

The rest of ``tests/test_optimize.py``'s bit-identity sweep, on the port
and on the CPU (``tests/test_torch_optimize.py`` has the vector cells and
the single launches' loop cells): each chain replays on ``loop`` with and
without ``optimize=True``, every buffer bit for bit.  The port's loop
lowering takes 10-20 s a run of srad_step and hotspot, so these cells have
a file of their own.
"""
import pytest

from repro_torch.core import cuda_suite
from test_torch_optimize import assert_optimized_bits_identical

CHAINS = [e for e in cuda_suite.build_suite(scale=1) if e.chain is not None]


@pytest.mark.parametrize("entry", CHAINS, ids=lambda e: e.name)
def test_optimized_bits_identical_loop(entry):
    assert_optimized_bits_identical(entry, "loop")
