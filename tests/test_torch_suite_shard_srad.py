"""srad_step on the shard backends at 1, 2 and 4 host workers, bit for
bit its inner lowering (``tests/test_torch_shard.py``'s rule), in a file
of its own: the port's ``loop`` lowering takes about 20 s a run of it."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_shard import HOSTS, shard_equals_inner  # noqa: E402

ENTRIES = ("srad_step",)


@pytest.mark.parametrize("hosts", HOSTS)
@pytest.mark.parametrize("name", ENTRIES)
@pytest.mark.parametrize("backend", ["shard", "shard_vector"])
def test_shard_equals_inner_bitwise(backend, name, hosts, monkeypatch):
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", str(hosts))
    shard_equals_inner(name, backend, hosts)
