"""``launch_batch`` rows against the reference's on ``loop``, for every
single-launch suite entry at ``build_suite(1)``: the rule of
``tests/test_torch_serve_parity.py`` (which does ``vector``), in a file
of its own because the port's ``loop`` lowering takes seconds a launch
at these sizes."""
import pytest

from test_torch_serve_parity import SINGLE, batch_rows_against_the_reference


@pytest.mark.parametrize("name", SINGLE)
def test_launch_batch_rows_are_the_references_on_loop(name):
    batch_rows_against_the_reference(name, "loop")
