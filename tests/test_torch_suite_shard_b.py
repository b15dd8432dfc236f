"""Suite entries on the shard backends at 1, 2 and 4 host workers, bit
for bit their inner lowering (``tests/test_torch_shard.py``'s rule): the
second half of the entries that ``tests/test_torch_suite_shard_*.py``
do not take one by one."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_shard import HOSTS, shard_equals_inner  # noqa: E402

ENTRIES = ("softmax_row", "scan_block", "transpose_tiled", "pixel_pipeline",
           "pathfinder", "needle_nw", "backprop_layer", "lavamd")


@pytest.mark.parametrize("hosts", HOSTS)
@pytest.mark.parametrize("name", ENTRIES)
@pytest.mark.parametrize("backend", ["shard", "shard_vector"])
def test_shard_equals_inner_bitwise(backend, name, hosts, monkeypatch):
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", str(hosts))
    shard_equals_inner(name, backend, hosts)
