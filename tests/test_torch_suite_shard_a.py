"""Suite entries on the shard backends at 1, 2 and 4 host workers, bit
for bit their inner lowering (``tests/test_torch_shard.py``'s rule): the
first half of the entries that ``tests/test_torch_suite_shard_*.py``
do not take one by one, and the reference's own 4-device check (its
``test_multidevice_subprocess``: histogram, matmul_tiled and reduce_warp
at grain 1 and 2)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_shard import HOSTS, shard_equals_inner  # noqa: E402

ENTRIES = ("reduce_shared", "matmul_tiled", "stencil1d", "stencil2d",
           "histogram", "reduce_warp", "reverse")


@pytest.mark.parametrize("hosts", HOSTS)
@pytest.mark.parametrize("name", ENTRIES)
@pytest.mark.parametrize("backend", ["shard", "shard_vector"])
def test_shard_equals_inner_bitwise(backend, name, hosts, monkeypatch):
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", str(hosts))
    shard_equals_inner(name, backend, hosts)


@pytest.mark.parametrize("grain", [1, 2])
@pytest.mark.parametrize("name", ["histogram", "matmul_tiled",
                                  "reduce_warp"])
def test_four_workers_at_grain(name, grain, monkeypatch):
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", "4")
    shard_equals_inner(name, "shard", 4, grain=grain)
