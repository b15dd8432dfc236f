"""The chain kernels' Hopper kernels on the card: needle_nw, pathfinder,
nn_reduce, nn_select and kmeans_update, and reverse's back-to-back
launches.

All six run on CTAs other than the chevron's blocks and are launched as
programmatic dependents of the work before them on the stream, so each
test holds the kernel against its plain version bit for bit at the edges
of its mapping (int buffers exactly, float ones bit for bit with a NaN
matching a NaN in the same place: nn's arg-min tree must keep its pairs
and their operand order under NaN; kmeans_update's as int32 patterns),
and the chains, where one launch reads what the launch before it wrote,
against host mode over their whole length, several times, as it does the
rows of a batch and back-to-back launches on one buffer.  Every test is marked ``gpu`` and skips
without a CUDA device; on a machine with one they run with
``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_chain_kernels_gpu.py``.  The file imports neither JAX
nor the reference package.
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import api, cuda_suite, lower_cuda  # noqa: E402
from repro_torch.core.dim3 import Dim3  # noqa: E402
from repro_torch.core.kernel import ChainStats  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the chain runs held against host mode, each mode
CHAIN_RUNS = 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.cache
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sizes() -> dict:
    return _smoke().SIZES


def _nw_state(n: int, d: int, seed: int) -> dict:
    """nw's buffers before the launch at diagonal ``d``: the oracle's
    matrix, the diagonal's cells set to a value no launch computes."""
    entry = cuda_suite.entry_needle_nw(n=n, penalty=10)
    args = entry.make_args(np.random.default_rng(seed))
    score = cuda_suite.nw_scores(args["score"], args["sim"], 10)
    i = np.arange(max(1, d - n), min(n, d - 1) + 1)
    score[i, d - i] = -(1 << 30)
    return {"score": score, "sim": args["sim"],
            "diag": np.full(1, d, np.int32)}


@pytest.mark.gpu
@pytest.mark.parametrize("where", ("first", "longest", "last", "below",
                                   "past"))
@pytest.mark.parametrize("n", (16, 48, 2048))
def test_needle_nw_bit_for_bit_on_the_card(card, n, where):
    # the chevron's n / 16 blocks of 16 on the diagonals 2, n + 1 and 2n,
    # and on 1 and 2n + 1, which hold no cell and write nothing
    d = {"first": 2, "longest": n + 1, "last": 2 * n, "below": 1,
         "past": 2 * n + 1}[where]
    kern = lower_cuda.KERNELS["needle_nw"]
    bufs = carry.from_reference(_nw_state(n, d, 7), device=card)
    grid, block = Dim3.of(n // 16), Dim3.of(16)
    before = kern.launches
    got = kern(bufs, grid=grid, block=block, n=n, penalty=10)
    want = kern.plain(bufs, grid, block, n=n, penalty=10)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(got["score"], want["score"])
    if where in ("below", "past"):
        assert torch.equal(got["score"], bufs["score"])
    else:
        oracle = cuda_suite.nw_scores(bufs["score"].cpu().numpy(),
                                      bufs["sim"].cpu().numpy(), 10)
        i = np.arange(max(1, d - n), min(n, d - 1) + 1)
        assert np.array_equal(got["score"].cpu().numpy()[i, d - i],
                              oracle[i, d - i])


def _offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` starting ``offset`` elements into a
    fresh allocation (4 bytes an element off its 16-byte boundary)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("row", (1, 4, -2, -40, 9, 1000))
@pytest.mark.parametrize("cols", (1, 63, 64, 100_000, 100_003))
def test_pathfinder_bit_for_bit_on_the_card(card, cols, row, offset):
    # a wall of 5 rows; row[0] in range, negative (wrapped once, then
    # clamped) and past the wall (clamped); buffers on 16-byte boundaries
    # and 4 bytes off them (the kernel's one-int path); the chevron's
    # ceil(cols / 64) blocks of 64, and a grid short of cols, whose dst
    # keeps its input past the columns it covers
    rng = np.random.default_rng(cols * 10_000 + row + 100)
    rows = 5
    host = {"wall": rng.integers(0, 10, (rows, cols), dtype=np.int32),
            "src": rng.integers(-50, 50, cols, dtype=np.int32),
            "dst": rng.integers(-50, 50, cols, dtype=np.int32),
            "row": np.full(1, row, np.int32)}
    bufs = {k: _offset(v, offset)
            for k, v in carry.from_reference(host, device=card).items()}
    if offset:
        assert all(t.data_ptr() % 16 for t in bufs.values())
    kern = lower_cuda.KERNELS["pathfinder"]
    for grid in {-(-cols // 64), max(1, cols // 200)}:
        work = {**bufs, "dst": _offset(bufs["dst"], offset)}
        want = kern.plain(work, Dim3.of(grid), Dim3.of(64), cols=cols)
        before = kern.launches
        with lower_cuda.in_place():        # into the (offset) dst itself
            kern(work, grid=grid, block=64, cols=cols)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(work["dst"], want["dst"]), grid


def _chain(entry, args, card, mode):
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0
    stats = ChainStats()
    out, _ = cuda_suite.run_entry(entry, "cuda", args=args,
                                  with_reference=False, device=card,
                                  chain_mode=mode, chain_stats=stats)
    torch.cuda.synchronize()
    launched = sum(lower_cuda.KERNELS[k].launches for k in
                   {s.kernel.name for s in cuda_suite.entry_steps(entry)})
    assert launched == stats.launches > 0, (mode, launched, stats.launches)
    return {k: v.cpu() for k, v in out.items()
            if k not in entry.iteration_state and k not in entry.const}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("device", "graph"))
@pytest.mark.parametrize("name", ("needle_nw", "pathfinder", "nn",
                                  "kmeans"))
def test_chains_at_full_size_equal_host_mode(card, name, mode):
    # chip_smoke.py's sizes (4,095, 99, 10 and 6 launches), each launch
    # reading what the one before wrote: a read ahead of
    # griddepcontrol.wait would show as a differing cell in some run
    entry = getattr(cuda_suite, f"entry_{name}")(**_sizes()[name])
    args = entry.make_args(np.random.default_rng(42))
    host = _chain(entry, args, card, "host")
    want = entry.reference(args)
    for k, v in want.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(host[k].numpy(), v, rtol=entry.tol,
                                       atol=entry.tol, err_msg=k)
        else:
            assert np.array_equal(host[k].numpy(), v), k
    for run in range(CHAIN_RUNS):
        got = _chain(entry, args, card, mode)
        for k, v in host.items():
            assert torch.equal(got[k], v), (run, k)


@pytest.mark.gpu
def test_needle_nw_batch_rows_equal_their_launches(card):
    # launch_batch runs the rows back to back on one stream, each launch
    # the programmatic dependent of the row before it, on other buffers
    n, d = 2048, 2049
    entry = cuda_suite.entry_needle_nw(n=n, penalty=10)
    rows = [carry.from_reference(_nw_state(n, d, seed), device=card)
            for seed in range(4)]
    kern = lower_cuda.KERNELS["needle_nw"]
    before = kern.launches
    batch = api.launch_batch(entry.kernel, grid=entry.grid,
                             block=entry.block, args_list=rows,
                             backend="cuda")
    torch.cuda.synchronize()
    assert kern.launches == before + 4
    for row, got in zip(rows, batch):
        alone = api.launch(entry.kernel, grid=entry.grid, block=entry.block,
                           args=row, backend="cuda")
        assert torch.equal(got["score"], alone["score"])
        assert not torch.equal(got["score"], row["score"])


def _same_bits(g: torch.Tensor, w: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN matching any NaN in the same place."""
    return _smoke().same_bits(g, w)


def _nn_reduce_host(n: int, block: int, nan: str, seed: int) -> dict:
    """nn_reduce's buffers: n records, an eighth of them taken, ``lat``
    NaN at block 0's first record, at one record of block 2 (t = 77 where
    the block holds it, a lane's third register; its last record
    otherwise), across block 1, or nowhere."""
    r = np.random.default_rng(seed)
    grid = -(-n // block)
    lat = r.uniform(0.0, 90.0, n).astype(np.float32)
    where = {"none": [], "first": [0],
             "later": [min(n - 1, 2 * block + min(77, block - 1))],
             "block": list(range(block, min(n, 2 * block)))}[nan]
    lat[where] = np.nan
    taken = np.zeros(n, np.int32)
    taken[r.choice(n, n // 8, replace=False)] = 1
    return {"lat": lat, "lng": r.uniform(0.0, 180.0, n).astype(np.float32),
            "target": np.asarray([30.0, 90.0], np.float32), "taken": taken,
            "pval": np.zeros(grid, np.float32),
            "pidx": np.zeros(grid, np.int32)}


@pytest.mark.gpu
@pytest.mark.parametrize("nan", ("none", "first", "later", "block"))
@pytest.mark.parametrize("n,block", [(64, 16), (1024, 256), (65536, 256),
                                     (2048, 1024), (1000, 256)])
def test_nn_reduce_bit_for_bit_on_the_card(card, n, block, nan):
    # a segment of 16 lanes, one and four registers a lane, the main
    # path's 256 blocks of 256, 32 registers a lane, and a ragged n whose
    # last block holds records past n (inf, index n - 1)
    kern = lower_cuda.KERNELS["nn_reduce"]
    bufs = carry.from_reference(_nn_reduce_host(n, block, nan, n + block),
                                device=card)
    grid = -(-n // block)
    before = kern.launches
    got = kern(bufs, grid=grid, block=block, n=n, nthreads=block)
    want = kern.plain(bufs, Dim3.of(grid), Dim3.of(block), n=n,
                      nthreads=block)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(got["pidx"], want["pidx"])
    assert _same_bits(got["pval"], want["pval"])
    if nan in ("first", "block"):           # a NaN on the left stays
        assert torch.isnan(got["pval"][0 if nan == "first" else 1])


@pytest.mark.gpu
@pytest.mark.parametrize("grid", (1, 2))
@pytest.mark.parametrize("step", (0, 3, -1, -5, 5, 100))
@pytest.mark.parametrize("nan", ("none", "first", "inner"))
@pytest.mark.parametrize("nblocks", (1, 4, 256, 1024))
def test_nn_select_bit_for_bit_on_the_card(card, nblocks, nan, step, grid):
    # partials tied on three values, NaN at partial 0 (never replaced) or
    # at partials inside the tree (never taken); step in range, wrapped
    # once (-1, -5) and dropped (5, 100) against 5 output slots; a grid of
    # 2 writes the same winner twice
    r = np.random.default_rng(nblocks * 100 + abs(step))
    pval = r.choice(np.asarray([1.0, 2.0, 4.0], np.float32), nblocks)
    if nan == "first":
        pval[0] = np.nan
    elif nan == "inner":
        pval[[nblocks // 2, nblocks - 1]] = np.nan
    records = nblocks * 64
    host = {"pval": pval,
            "pidx": r.permutation(records)[:nblocks].astype(np.int32),
            "step": np.asarray([step], np.int32),
            "out_d": np.full(5, -1.0, np.float32),
            "out_i": np.full(5, -1, np.int32),
            "taken": np.zeros(records, np.int32)}
    kern = lower_cuda.KERNELS["nn_select"]
    bufs = carry.from_reference(host, device=card)
    before = kern.launches
    got = kern(bufs, grid=grid, block=nblocks, nblocks=nblocks)
    want = kern.plain(bufs, Dim3.of(grid), Dim3.of(nblocks), nblocks=nblocks)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    for k in kern.writes:
        assert _same_bits(got[k], want[k]), k
    assert int(got["taken"].sum()) == 1


@pytest.mark.gpu
def test_nn_reduce_batch_rows_equal_their_launches(card):
    # launch_batch runs the rows back to back on one stream, each launch
    # the programmatic dependent of the row before it, on other buffers
    entry = cuda_suite.entry_nn(**_sizes()["nn"])
    rows = [carry.from_reference(
        _nn_reduce_host(65536, 256, nan, seed), device=card)
        for seed, nan in enumerate(("none", "first", "later", "block"))]
    kern = lower_cuda.KERNELS["nn_reduce"]
    before = kern.launches
    batch = api.launch_batch(entry.kernel, grid=entry.grid,
                             block=entry.block, args_list=rows,
                             backend="cuda")
    torch.cuda.synchronize()
    assert kern.launches == before + 4
    for row, got in zip(rows, batch):
        alone = api.launch(entry.kernel, grid=entry.grid, block=entry.block,
                           args=row, backend="cuda")
        assert torch.equal(got["pidx"], alone["pidx"])
        assert _same_bits(got["pval"], alone["pval"])
        assert not torch.equal(got["pidx"], row["pidx"])


#: kmeans_update's counts off the entry's path: zero (the centroid
#: stays), negative (divided by 1), one, and past 2^24 (the count's float
#: rounds); its sums: NaN, signed zeros, values whose quotient rounds
UPDATE_COUNTS = np.asarray([0, -2, 1, 3, -1, 1 << 24, (1 << 24) + 1,
                            (1 << 25) + 3, -(1 << 25) - 3, 7, 0x7FFFFFFF,
                            -(1 << 31)], np.int64).astype(np.int32)
UPDATE_SUMS = np.asarray([6.0, 5.0, 0.0, -0.0, np.nan, 1e30, 16777217.0,
                          -3.0, 123.25, 1e-30, 2.0, -7.5], np.float32)


def _kmeans_update_host(k: int, seed: int) -> dict:
    """kmeans_update's buffers at k clusters, each count, sum and
    centroid drawn from the edge values above."""
    r = np.random.default_rng(seed)
    return {"sumx": r.choice(UPDATE_SUMS, k),
            "sumy": r.choice(UPDATE_SUMS, k),
            "count": r.choice(UPDATE_COUNTS, k),
            "cx": r.uniform(-100, 100, k).astype(np.float32),
            "cy": r.choice(UPDATE_SUMS, k)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("k", (1, 4, 32, 33, 100, 300))
def test_kmeans_update_bit_for_bit_on_the_card(card, k, seed):
    # a lane a cluster: one warp, a ragged second warp, four warps, and
    # two CTAs (300 clusters); cx and cy as int32 patterns
    kern = lower_cuda.KERNELS["kmeans_update"]
    bufs = carry.from_reference(_kmeans_update_host(k, k * 10 + seed),
                                device=card)
    before = kern.launches
    got = kern(bufs, grid=k, block=8, k=k)
    want = kern.plain(bufs, Dim3.of(k), Dim3.of(8), k=k)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    for name in kern.writes:
        assert torch.equal(_bits(got[name]), _bits(want[name])), name


@pytest.mark.gpu
def test_kmeans_update_divides_a_negative_count_by_one_on_the_card(card):
    # the reference's rule: max(count, 1) divides, only a zero count keeps
    # the centroid
    host = {"sumx": np.float32([6, 5, 9, 10]),
            "sumy": np.float32([4, 1, 3, 7]),
            "count": np.int32([-2, 0, 3, 5]),
            "cx": np.float32([1, 2, 3, 4]), "cy": np.float32([5, 6, 7, 8])}
    kern = lower_cuda.KERNELS["kmeans_update"]
    got = kern(carry.from_reference(host, device=card), grid=4, block=8,
               k=4)
    torch.cuda.synchronize()
    assert got["cx"].cpu().tolist() == [6.0, 2.0, 3.0, 2.0]
    assert np.array_equal(got["cy"].cpu().numpy(),
                          np.float32([4, 6, 1, 1.4]))


@pytest.mark.gpu
def test_kmeans_update_batch_rows_equal_their_launches(card):
    # launch_batch runs the rows back to back on one stream, each launch
    # the programmatic dependent of the row before it, on other buffers
    k = 33
    kernel = cuda_suite.make_kmeans_update(k)
    rows = [carry.from_reference(_kmeans_update_host(k, seed), device=card)
            for seed in range(4)]
    kern = lower_cuda.KERNELS["kmeans_update"]
    before = kern.launches
    batch = api.launch_batch(kernel, grid=k, block=8, args_list=rows,
                             backend="cuda")
    torch.cuda.synchronize()
    assert kern.launches == before + 4
    for row, got in zip(rows, batch):
        alone = api.launch(kernel, grid=k, block=8, args=row, backend="cuda")
        for name in ("cx", "cy"):
            assert torch.equal(_bits(got[name]), _bits(alone[name])), name
        assert not torch.equal(_bits(got["cx"]), _bits(row["cx"]))


def _reverse_rows(count: int) -> list[dict]:
    return [{"d": torch.from_numpy(np.random.default_rng(seed).integers(
        -50, 50, 1024).astype(np.int32))} for seed in range(count)]


@pytest.mark.gpu
def test_reverse_batch_rows_equal_their_launches(card):
    # eight rows back to back on one stream, each a programmatic dependent
    # of the row before it, on other buffers
    entry = cuda_suite.entry_reverse(n=1024)
    rows = [carry.from_reference({"d": r["d"].numpy()}, device=card)
            for r in _reverse_rows(8)]
    kern = lower_cuda.KERNELS["reverse"]
    before = kern.launches
    batch = api.launch_batch(entry.kernel, grid=1, block=1024,
                             dyn_shared=1024, args_list=rows,
                             backend="cuda")
    torch.cuda.synchronize()
    assert kern.launches == before + 8
    for row, got in zip(rows, batch):
        alone = api.launch(entry.kernel, grid=1, block=1024,
                           dyn_shared=1024, args=row, backend="cuda")
        assert torch.equal(got["d"], alone["d"])
        assert torch.equal(got["d"], row["d"].flip(0))


@pytest.mark.gpu
@pytest.mark.parametrize("block,dyn", ((1024, 1024), (1000, 1028),
                                       (1000, 1029)))
def test_reverse_back_to_back_launches_equal_one(card, block, dyn):
    # 511 launches on one buffer, each the programmatic dependent of the
    # one before it, which is still writing what it reads: an odd count of
    # an involution (the zeros below ns - block stay zeros) equals one
    kern = lower_cuda.KERNELS["reverse"]
    d = _reverse_rows(1)[0]["d"].to(card)
    want = kern({"d": d}, grid=1, block=block, n=1024, dyn_shared=dyn)
    for run in range(CHAIN_RUNS):
        work = {"d": d.clone()}
        before = kern.launches
        for _ in range(511):
            kern.launch_into(work, Dim3(1), Dim3(block), n=1024,
                             dyn_shared=dyn)
        torch.cuda.synchronize()
        assert kern.launches == before + 511
        assert torch.equal(work["d"], want["d"]), run
