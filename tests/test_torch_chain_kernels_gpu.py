"""needle_nw's and pathfinder's Hopper kernels on the card.

Both run on CTAs other than the chevron's blocks and are launched as
programmatic dependents of the work before them on the stream, so each
test holds the kernel against its plain version bit for bit (both are
int32) at the edges of its mapping, and the chains, where one launch
reads what the launch before it wrote, against host mode over their
whole length, several times.  Every test is marked ``gpu`` and skips
without a CUDA device; on a machine with one they run with
``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_chain_kernels_gpu.py``.  The file imports neither JAX
nor the reference package.
"""
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


def _sizes() -> dict:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIZES


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
    launched = lower_cuda.KERNELS[entry.name].launches
    assert launched == stats.launches > 0, (mode, launched, stats.launches)
    return {k: v.cpu() for k, v in out.items()
            if k not in entry.iteration_state}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ("device", "graph"))
@pytest.mark.parametrize("name", ("needle_nw", "pathfinder"))
def test_chains_at_full_size_equal_host_mode(card, name, mode):
    # chip_smoke.py's sizes (4,095 and 99 launches), each launch reading
    # what the one before wrote: a read ahead of griddepcontrol.wait would
    # show as a differing cell in some run
    entry = getattr(cuda_suite, f"entry_{name}")(**_sizes()[name])
    args = entry.make_args(np.random.default_rng(42))
    host = _chain(entry, args, card, "host")
    want = entry.reference(args)
    for k, v in want.items():
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
