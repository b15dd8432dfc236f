"""Every block id runs exactly once on the shard backends, for random
grids, device counts and grains (a hypothesis property).

The kernel counts its block into a per-block int32 counter: a block run
twice (a grain tail re-running the next shard's first block) or never (a
shard range cut short) leaves a count other than 1.  The counts combine
under the default ``sum``, which is exact on integers.
"""
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as hst  # noqa: E402

from repro_torch.core import Dim3, KernelDef, launch  # noqa: E402


def _count_blocks():
    def stage(ctx, st):
        hits = torch.full(ctx.tid.shape, ctx.bid, dtype=torch.int32)
        hits = torch.where(ctx.tid == 0, hits, -1)     # one thread a block
        return st.set_glob(count=ctx.atomic_add(st.glob["count"], hits,
                                                torch.ones_like(hits)))

    return KernelDef("count_blocks", (stage,), writes=("count",),
                     reads=("count",))


KERNEL = _count_blocks()


@settings(max_examples=60, deadline=None)
@given(grid=hst.tuples(hst.integers(1, 13), hst.integers(1, 3)),
       devices=hst.integers(1, 4),
       grain=hst.one_of(hst.integers(1, 6),
                        hst.sampled_from(["average", "aggressive"])),
       backend=hst.sampled_from(["shard", "shard_vector"]),
       block=hst.sampled_from([1, 2]))
def test_every_block_runs_exactly_once(grid, devices, grain, backend, block):
    # hypothesis runs every example inside one function-scoped fixture, so
    # the pool is set here rather than with monkeypatch
    old = os.environ.get("CUPBOP_HOST_DEVICES")
    os.environ["CUPBOP_HOST_DEVICES"] = "4"
    try:
        n = Dim3.of(grid).size
        out = launch(KERNEL, grid=grid, block=block, backend=backend,
                     devices=devices, grain=grain, pool=devices,
                     args={"count": torch.zeros(n, dtype=torch.int32)})
    finally:
        if old is None:
            del os.environ["CUPBOP_HOST_DEVICES"]
        else:
            os.environ["CUPBOP_HOST_DEVICES"] = old
    assert out["count"].tolist() == [1] * n
