"""The ``cuda`` backend's build, and its kernels on the card.

The build tests run anywhere.  The tests marked ``gpu`` need a CUDA
device and ``nvcc``; they skip elsewhere, and on a machine with a card
they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_native.py``.
"""
import importlib.util
import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import _native, cuda_suite, lower_cuda  # noqa: E402
from repro_torch.core.dim3 import Dim3  # noqa: E402
from repro_torch.core.kernel import UnsupportedKernel  # noqa: E402

#: the port's registry, in the reference's order
SUITE = {e.name: e for e in cuda_suite.build_suite(1)}
NAMES = tuple(SUITE)
#: each kernel's (entry, step index in the chain's iteration)
STEPS = {step.kernel.name: (name, i) for name in NAMES
         for i, step in enumerate(cuda_suite.entry_steps(SUITE[name]))}


def test_build_key_covers_every_source_and_flag(monkeypatch, tmp_path):
    before = _native.source_hash()
    for src in _native.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    assert _native.source_hash() == before
    (tmp_path / "needle_nw.cu").write_text(
        (tmp_path / "needle_nw.cu").read_text() + "\n// edited\n")
    edited = _native.source_hash()
    assert edited != before
    monkeypatch.setattr(_native, "COMPILE_FLAGS",
                        (*_native.COMPILE_FLAGS, "-lineinfo"))
    assert _native.source_hash() not in (before, edited)


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present here")
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "TOOLKIT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build()
    assert not (tmp_path / "build").exists()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bfs_state(args, dist, level):
    """bfs's buffers before the chain's launch at ``level``."""
    return {**args, "frontier": (dist == level).astype(np.int32),
            "visited": ((dist >= 0) & (dist <= level)).astype(np.int32),
            "dist": np.where(dist <= level, dist, -1).astype(np.int32),
            "level": np.full(1, level, np.int32)}


def _state(name):
    entry = (cuda_suite.entry_bfs_frontier(n=1024, deg=6)
             if name == "bfs_frontier" else SUITE[name])
    args = entry.make_args(np.random.default_rng(42))
    if name == "bfs_frontier":
        dist = cuda_suite.bfs_levels(args["edges"], 1024)
        args = _bfs_state(args, dist,
                          int(np.bincount(dist[dist >= 0]).argmax()))
    return entry, args


def _launch(step, bufs):
    return lower_cuda.KERNELS[step.kernel.name](
        bufs, grid=step.grid, block=step.block,
        **lower_cuda.launch_params(step.kernel, step.dyn_shared))


#: kernels whose float results equal their plain versions bit for bit
BIT_EXACT = ("srad_stats", "nn_reduce", "nn_select", "kmeans_assign",
             "kmeans_update", "vecadd", "reduce_shared", "reduce_warp",
             "stencil1d", "stencil2d", "scan_block", "transpose_tiled",
             "hotspot", "lud_diag")


@pytest.mark.gpu
@pytest.mark.parametrize("kname", tuple(STEPS))
def test_kernel_matches_its_plain_version_on_the_card(card, kname):
    # a later step of a chain runs on the state one launch of each step
    # before it leaves, after its own prepare hook
    name, j = STEPS[kname]
    entry, args = _state(name)
    steps = cuda_suite.entry_steps(entry)
    bufs = carry.from_reference(args, device=card)
    for step in steps[:j]:
        bufs = {**bufs, **_launch(step, bufs)}
    step = steps[j]
    if j and step.prepare is not None:
        bufs = {**bufs, **step.prepare(0, bufs)}
    kern = lower_cuda.KERNELS[kname]
    params = lower_cuda.launch_params(step.kernel, step.dyn_shared)
    before = kern.launches
    got = _launch(step, bufs)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(bufs, Dim3.of(step.grid), Dim3.of(step.block),
                      **params)
    for k in kern.writes:
        if got[k].is_floating_point() and kname not in BIT_EXACT:
            torch.testing.assert_close(got[k], want[k], rtol=entry.tol,
                                       atol=entry.tol)
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_backprop_maps_a_wide_logical_block_onto_1024_threads(card):
    # 4096 inputs: each thread folds four in registers, in the
    # reference's tree order, before the shared tree
    entry = cuda_suite.entry_backprop_layer(in_n=4096, out_n=3)
    out, want = cuda_suite.run_entry(entry, "cuda", device=card)
    for k, v in want.items():
        np.testing.assert_allclose(out[k].cpu().numpy(), v, rtol=entry.tol,
                                   atol=entry.tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_run_entry_on_the_default_device(card, name):
    entry = SUITE[name]
    out, want = cuda_suite.run_entry(entry, "cuda")
    for k, v in want.items():
        assert out[k].device.type == "cuda"
        np.testing.assert_allclose(out[k].cpu().numpy(), v, rtol=entry.tol,
                                   atol=entry.tol)


@pytest.mark.gpu
def test_reverse_takes_its_shared_extent_from_the_launch(card):
    # 1024 threads (CUDA's widest block) over 1024 ints of extern shared
    # memory; a smaller extent is refused before anything launches
    entry = cuda_suite.entry_reverse(n=1024)
    assert entry.block == entry.dyn_shared == 1024
    out, want = cuda_suite.run_entry(entry, "cuda", device=card)
    assert torch.equal(out["d"].cpu(), torch.from_numpy(want["d"]))
    kern = lower_cuda.KERNELS["reverse"]
    before = kern.launches
    with pytest.raises(UnsupportedKernel, match="smaller than the block"):
        entry.kernel[1, 1024, 1000].on(backend="cuda")(d=out["d"])
    assert kern.launches == before
    # a wider extent: the cells past the block read as zeros
    got = entry.kernel[1, 512, 1536].on(backend="cuda")(d=out["d"])
    want = kern.plain({"d": out["d"]}, Dim3(1), Dim3(512), n=1024,
                      dyn_shared=1536)
    assert torch.equal(got["d"], want["d"])


@pytest.mark.gpu
@pytest.mark.parametrize("grid", (2, 3))
def test_reverse_runs_a_grid_as_passes_of_one_block_on_the_card(card, grid):
    # the reference's blocks reverse the same d one after another; the
    # plain version does so (held to the reference's loop backend on the
    # CPU), and the kernel computes the passes' closed form in one launch
    entry = cuda_suite.entry_reverse(n=1024)
    d = carry.from_reference(entry.make_args(np.random.default_rng(42)),
                             device=card)["d"]
    kern = lower_cuda.KERNELS["reverse"]
    for block, dyn in ((1024, 1024), (512, 1536)):
        before = kern.launches
        got = entry.kernel[grid, block, dyn].on(backend="cuda")(d=d)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        want = kern.plain({"d": d.cpu()}, Dim3(grid), Dim3(block), n=1024,
                          dyn_shared=dyn)
        assert torch.equal(got["d"].cpu(), want["d"])


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("grid", (1, 2, 3, 4))
@pytest.mark.parametrize("extra", (0, 1, 5, 28, 300, 2100))
@pytest.mark.parametrize("block", (1, 31, 32, 96, 1000, 1024))
def test_reverse_closed_form_bit_for_bit_on_the_card(card, block, extra,
                                                      grid, offset):
    # the extent ns = block + extra: the window [ns - block, block) whole,
    # cut at odd and even edges (a middle cell where its length is odd),
    # or empty; one and two passes and more; d on a 16-byte boundary (the
    # 16-byte pairs where the window's edges allow, with a tail of
    # one-int pairs at block 1000, extra 28) and 4 bytes past it (one int
    # a lane); the cells past the block keep their values
    host = {"d": torch.from_numpy(np.random.default_rng(block + extra)
                                  .integers(-50, 50, 1024)
                                  .astype(np.int32))}
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS["reverse"]
    ns = block + extra
    before = kern.launches
    with lower_cuda.in_place():
        kern(bufs, grid=grid, block=block, n=1024, dyn_shared=ns)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(host, Dim3(grid), Dim3(block), n=1024,
                      dyn_shared=ns)["d"]
    assert torch.equal(bufs["d"].cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", (16, 5))
def test_histogram_contiguous_layout_on_the_card(card, grid):
    entry = cuda_suite.entry_histogram(layout="contiguous")
    out, want = cuda_suite.run_entry(entry, "cuda", grid=grid, device=card)
    kern = lower_cuda.KERNELS["histogram_contiguous"]
    bufs = carry.from_reference(entry.make_args(np.random.default_rng(42)),
                                device=card)
    plain = kern.plain(bufs, Dim3(grid), Dim3(entry.block),
                       **dict(entry.kernel.native.params))
    assert torch.equal(out["hist"], plain["hist"])
    if grid == entry.grid:
        np.testing.assert_array_equal(out["hist"].cpu().numpy(),
                                      want["hist"])


@pytest.mark.gpu
def test_stencil1d_at_a_ragged_n_on_the_card(card):
    # the last block's threads past n clamp their reads and store nothing
    entry = cuda_suite.entry_stencil1d(4000, 128)
    out, want = cuda_suite.run_entry(entry, "cuda", device=card)
    np.testing.assert_array_equal(out["y"].cpu().numpy(), want["y"])


@pytest.mark.gpu
def test_scan_block_keeps_the_sign_of_zero_on_the_card(card):
    entry = cuda_suite.entry_scan_block()
    args = entry.make_args(np.random.default_rng(42))
    args["x"][:256] = -0.0
    bufs = carry.from_reference(args, device=card)
    kern = lower_cuda.KERNELS["scan_block"]
    params = lower_cuda.launch_params(entry.kernel)
    got = kern(bufs, grid=entry.grid, block=entry.block, **params)
    want = kern.plain(bufs, Dim3(entry.grid), Dim3(entry.block), **params)
    assert torch.equal(got["y"], want["y"])
    assert torch.equal(torch.signbit(got["y"]), torch.signbit(want["y"]))


def _matmul_bufs(m, n, k):
    # c starts nonzero, so the outputs a partial grid leaves are seen kept
    r = np.random.default_rng(42)
    return {"a": torch.from_numpy(r.standard_normal((m, k), np.float32)),
            "b": torch.from_numpy(r.standard_normal((k, n), np.float32)),
            "c": torch.from_numpy(r.standard_normal((m, n), np.float32))}


def _matmul_on_the_card(bufs, grid):
    m, k = bufs["a"].shape
    n = bufs["b"].shape[1]
    kern = lower_cuda.KERNELS["matmul_tiled"]
    before = kern.launches
    got = kern(bufs, grid=grid, block=64, m=m, n=n, k=k)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain({name: t.cpu() for name, t in bufs.items()},
                      Dim3(grid), Dim3(64), m=m, n=n, k=k)
    tol = cuda_suite.matmul_tol(k)
    torch.testing.assert_close(got["c"].cpu(), want["c"], rtol=tol,
                               atol=tol)
    return got["c"].cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", ((136, 200, 48), (8, 8, 8),
                                   (72, 24, 40), (256, 256, 2048)))
def test_matmul_tiled_at_shapes_off_its_128_wide_ctas(card, m, n, k):
    # m and n need not be multiples of the physical CTA's 128: rows and
    # columns past them load zeros and store nothing; an odd count of
    # 8-deep k-tiles (k = 8, 40) ends in a slice of one k-tile
    bufs = {name: t.to(card) for name, t in
            _matmul_bufs(m, n, k).items()}
    c = _matmul_on_the_card(bufs, (m // 8) * (n // 8))
    assert torch.isfinite(c).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,grid", ((32, 32, 5), (136, 200, 82)))
def test_matmul_tiled_partial_grid_keeps_c_past_it(card, m, n, grid):
    # 5 of 16 tiles; 82 of 425 tiles, ending 7 tiles into tile row 3:
    # outputs of tiles at or past the grid keep c's input bits
    bufs = {name: t.to(card) for name, t in
            _matmul_bufs(m, n, 16).items()}
    c = _matmul_on_the_card(bufs, grid)
    tile = (torch.arange(m)[:, None] // 8) * (n // 8) \
        + torch.arange(n)[None, :] // 8
    kept = tile >= grid
    assert torch.equal(c[kept], bufs["c"].cpu()[kept])
    assert not torch.equal(c[~kept], bufs["c"].cpu()[~kept])


@pytest.mark.gpu
def test_matmul_tiled_takes_views_off_a_16_byte_boundary(card):
    # a and b 4 bytes past a 16-byte boundary: the launcher starts the
    # instantiation of scalar loads (the source note's path)
    m, n, k = 136, 200, 48
    host = _matmul_bufs(m, n, k)
    bufs = {"c": host["c"].to(card)}
    for name in ("a", "b"):
        flat = torch.zeros(host[name].numel() + 1, device=card)
        flat[1:] = host[name].reshape(-1).to(card)
        bufs[name] = flat[1:].view(host[name].shape)
        assert bufs[name].is_contiguous() and bufs[name].data_ptr() % 16
    _matmul_on_the_card(bufs, (m // 8) * (n // 8))


def _reduce_on_the_card(card, kname, n, block, grid, outs):
    """One launch of ``kname`` (reduce_shared, reduce_warp or srad_stats)
    over ``n`` floats (srad_stats: one row of ``n`` pixels) into outputs
    of the lengths ``outs`` gives, random bits in both; held to the plain
    version bit for bit."""
    r = np.random.default_rng(42)
    x = torch.from_numpy(r.standard_normal(n, np.float32))
    if kname == "srad_stats":
        bufs, params = {"x": x.view(1, n)}, {"h": 1, "w": n}
    else:
        bufs, params = {"x": x}, {"n": n}
    params["nthreads"] = block
    for name, m in outs.items():
        bufs[name] = torch.from_numpy(r.standard_normal(m, np.float32))
    kern = lower_cuda.KERNELS[kname]
    before = kern.launches
    got = kern({name: t.to(card) for name, t in bufs.items()}, grid=grid,
               block=block, **params)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(bufs, Dim3(grid), Dim3(block), **params)
    for name in outs:
        assert torch.equal(got[name].cpu(), want[name])


def _outs(kname, n_out):
    return ({"psum": n_out, "psq": n_out} if kname == "srad_stats"
            else {"out": n_out})


@pytest.mark.gpu
@pytest.mark.parametrize("kname,n,block", (
    ("reduce_shared", 1000, 1), ("reduce_shared", 999, 2),
    ("reduce_shared", 1000, 16), ("reduce_shared", 1000, 32),
    ("reduce_shared", 3000, 64), ("reduce_shared", 70000, 256),
    ("reduce_shared", 1000, 1024), ("reduce_shared", 5000, 1024),
    ("reduce_warp", 1000, 32), ("reduce_warp", 3000, 64),
    ("reduce_warp", 1000, 96), ("reduce_warp", 70000, 256),
    ("reduce_warp", 5000, 480), ("reduce_warp", 5000, 1024),
    ("srad_stats", 1000, 1), ("srad_stats", 999, 2),
    ("srad_stats", 1000, 4), ("srad_stats", 1000, 8),
    ("srad_stats", 1000, 16), ("srad_stats", 1000, 32),
    ("srad_stats", 3000, 64), ("srad_stats", 5000, 128),
    ("srad_stats", 70000, 256), ("srad_stats", 5000, 512),
    ("srad_stats", 5000, 1024)))
def test_reduce_shared_has_the_plain_version_bits(card, kname, n, block):
    # the register and shuffle levels pair as the reference's barrier tree
    # or butterflies do; blocks below a warp are segments of its lanes;
    # srad_stats's partials are npix // block long, so a ragged last
    # block falls past them
    grid = -(-n // block)
    _reduce_on_the_card(card, kname, n, block, grid,
                        _outs(kname, n // block if kname == "srad_stats"
                              else grid))


@pytest.mark.gpu
@pytest.mark.parametrize("kname,block,grid,n_out", (
    ("reduce_shared", 256, 10, 10), ("reduce_shared", 16, 100, 90),
    ("reduce_shared", 1024, 3, 5),
    ("reduce_warp", 256, 10, 10), ("reduce_warp", 32, 100, 90),
    ("reduce_warp", 96, 20, 25), ("reduce_warp", 1024, 3, 5),
    ("srad_stats", 256, 10, 3), ("srad_stats", 16, 100, 62),
    ("srad_stats", 1, 1100, 1000)))
def test_reduce_shared_grid_past_the_data(card, kname, block, grid, n_out):
    # blocks past n sum zeros; sums past out are dropped, and out past
    # the grid keeps its input (srad_stats's partials are npix // block
    # long, which a grid past the data always passes)
    n = 1000
    assert grid > -(-n // block)
    _reduce_on_the_card(card, kname, n, block, grid, _outs(kname, n_out))


@pytest.mark.gpu
@pytest.mark.parametrize("kname,block,grid", (
    ("reduce_shared", 16, 41), ("reduce_shared", 256, 2),
    ("reduce_warp", 32, 21), ("reduce_warp", 96, 7),
    ("srad_stats", 2, 301), ("srad_stats", 16, 41),
    ("srad_stats", 128, 5)))
def test_reduce_grid_short_of_the_data(card, kname, block, grid):
    # the outputs past the grid keep their input bits; an odd grid of
    # blocks below a warp ends in the middle of the last warp's lanes
    n = 1000
    assert grid < n // block
    _reduce_on_the_card(card, kname, n, block, grid,
                        _outs(kname, n // block))


def _softmax_on_the_card(card, rows, block, grid, offset=0):
    """One launch of softmax_row over x[rows, block] into y, random bits
    in both, with x and y ``offset`` floats past a 16-byte boundary; held
    to the plain version within the entry's tol, the rows past the grid
    to y's input bits."""
    r = np.random.default_rng(42)
    host = {"x": torch.from_numpy(3 * r.standard_normal((rows, block),
                                                        np.float32)),
            "y": torch.from_numpy(r.standard_normal((rows, block),
                                                    np.float32))}
    bufs = {}
    for name, t in host.items():
        flat = torch.zeros(t.numel() + 4, device=card)
        bufs[name] = flat[offset:offset + t.numel()].view(rows, block)
        bufs[name].copy_(t.to(card))
    kern = lower_cuda.KERNELS["softmax_row"]
    params = {"rows": rows, "nthreads": block}
    before = kern.launches
    kern.launch_into(bufs, Dim3(grid), Dim3(block), **params)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = bufs["y"].cpu()
    want = kern.plain(host, Dim3(grid), Dim3(block), **params)["y"]
    tol = cuda_suite.entry_softmax_row(rows, block).tol
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(got[grid:], host["y"][grid:])


@pytest.mark.gpu
@pytest.mark.parametrize("block", tuple(range(32, 1025, 32)))
def test_softmax_row_at_every_block_it_admits(card, block):
    # B / 32 values a lane, in float4s, float2s or floats by B; 33 rows,
    # so the last of five CTAs holds one live warp
    _softmax_on_the_card(card, 33, block, 33)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,block,grid", (
    (7, 128, 7), (40, 128, 7), (40, 96, 33), (9, 1024, 2), (16, 64, 9)))
def test_softmax_row_grid_short_of_the_rows(card, rows, block, grid):
    # a grid that is not a multiple of a CTA's 8 warps, at or below the
    # rows: the rows past it keep y
    _softmax_on_the_card(card, rows, block, grid)


@pytest.mark.gpu
@pytest.mark.parametrize("block", (32, 64, 96, 128, 512, 1024))
def test_softmax_row_takes_views_off_a_16_byte_boundary(card, block):
    # x and y 4 bytes past a 16-byte boundary: the launcher starts the
    # instantiation of one float an access
    _softmax_on_the_card(card, 33, block, 30, offset=1)


def _vecadd_on_the_card(card, n, grid, block, off=""):
    """One launch of vecadd over a, b, c of n floats, random bits in all
    three, the buffer named ``off`` one float past a 16-byte boundary; c
    equals the plain version, and a + b from NumPy below the grid's
    threads, bit for bit, and keeps its input bits past them."""
    r = np.random.default_rng(42)
    host = {k: torch.from_numpy(r.standard_normal(n, np.float32))
            for k in "abc"}
    bufs = {}
    for k, t in host.items():
        o = int(k == off)
        bufs[k] = torch.zeros(n + 4, device=card)[o:o + n]
        bufs[k].copy_(t.to(card))
        assert bool(bufs[k].data_ptr() % 16) == bool(o)
    kern = lower_cuda.KERNELS["vecadd"]
    before = kern.launches
    kern.launch_into(bufs, Dim3(grid), Dim3(block), n=n)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = bufs["c"].cpu()
    want = kern.plain(host, Dim3(grid), Dim3(block), n=n)["c"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    m = min(n, grid * block)
    added = host["a"].numpy()[:m] + host["b"].numpy()[:m]
    np.testing.assert_array_equal(got.numpy()[:m].view(np.int32),
                                  added.view(np.int32))
    assert torch.equal(got[m:].view(torch.int32),
                       host["c"][m:].view(torch.int32))


#: (n, grid, block): the main path; n % 4 of 1, 2, 3 under a grid past
#: n; fewer elements than a float4; grids short of n (m = 5120, and 1287
#: with m % 4 = 3); a grid far past n
VECADD = ((1 << 24, 1 << 17, 128), (4097, 33, 128), (4098, 33, 128),
          (4099, 33, 128), (1, 1, 128), (3, 1, 32), (10_000, 40, 128),
          (10_000, 13, 99), (1000, 100, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("n,grid,block", VECADD)
def test_vecadd_writes_the_grids_elements_bit_for_bit(card, n, grid, block):
    # 16-byte aligned: two float4s a thread, the last CTA adding the
    # elements past the last whole float4 one a thread
    _vecadd_on_the_card(card, n, grid, block)


@pytest.mark.gpu
@pytest.mark.parametrize("off", ("a", "b", "c"))
@pytest.mark.parametrize("n,grid,block", ((4099, 33, 128),
                                          (10_000, 13, 99)))
def test_vecadd_takes_views_off_a_16_byte_boundary(card, off, n, grid,
                                                   block):
    # one buffer 4 bytes off: the launcher starts one element a thread
    _vecadd_on_the_card(card, n, grid, block, off)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,want", zip(VECADD, (8192, 2, 2, 2, 1, 1, 3,
                                                    1, 1)))
def test_vecadd_ctas_cover_the_grids_float4s(card, shape, want):
    # the launcher's own count: 512 float4s a CTA of 256, one CTA at
    # least for fewer than four elements
    assert lower_cuda.vecadd_ctas(*shape) == want


@pytest.mark.gpu
@pytest.mark.parametrize("block", (1025, 2048))
def test_vecadd_refuses_a_block_the_chevron_refuses(card, block):
    # the launcher starts CTAs of its own, so it refuses for CUDA a block
    # past 1024 threads
    bufs = {k: torch.zeros(4096, device=card) for k in "abc"}
    with pytest.raises(RuntimeError, match="launch_vecadd"):
        lower_cuda.KERNELS["vecadd"](bufs, grid=1, block=block, n=4096)


#: (h, w, grid) of transpose_tiled: the main path; partial grids of 5 and
#: 65 tiles and one ending mid-row of a physical CTA (3 tile rows and 5
#: tiles, of 8 x 8 a CTA); h != w, sides off the CTA's 64, a grid of
#: one tile, one tile column, one tile row
TRANSPOSE = ((4096, 4096, 262_144), (256, 256, 5), (256, 256, 65),
             (256, 256, 101), (128, 384, 768), (384, 136, 816),
             (72, 200, 50), (8, 8, 1), (64, 8, 8), (8, 1024, 100))


@pytest.mark.parametrize("side", (32, 64))
@pytest.mark.parametrize("h,w,grid", TRANSPOSE)
def test_transpose_tiled_ctas_cover_the_grids_tiles(monkeypatch, h, w,
                                                     grid, side):
    # the least physical grid that holds every logical tile below the
    # grid: the largest CTA column and row any of them falls in.  The
    # CTA's side comes from the kernel's source on the card; here it is
    # each of the squares the design was timed at
    monkeypatch.setattr(lower_cuda, "transpose_tiled_side", lambda: side)
    per_row = w // 8
    cx = cy = 0
    for tile in range(grid):
        by, bx = divmod(tile, per_row)
        cx, cy = max(cx, bx * 8 // side + 1), max(cy, by * 8 // side + 1)
    assert lower_cuda.transpose_tiled_ctas(h, w, grid) == (cx, cy)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("h,w,grid", TRANSPOSE)
def test_transpose_tiled_bit_for_bit_on_the_card(card, h, w, grid, offset):
    # y equals the plain version's bits: x's where the grid covers the
    # tile, its own input past the grid; x 4 bytes past a 16-byte
    # boundary takes the launcher's one-float path
    r = np.random.default_rng(42)
    host = {"x": torch.from_numpy(r.standard_normal((h, w), np.float32)),
            "y": torch.from_numpy(r.standard_normal((w, h), np.float32))}
    bufs = {}
    for name, t in host.items():
        flat = torch.zeros(t.numel() + 4, device=card)
        bufs[name] = flat[offset:offset + t.numel()].view(t.shape)
        bufs[name].copy_(t.to(card))
        assert bool(bufs[name].data_ptr() % 16) == bool(offset)
    kern = lower_cuda.KERNELS["transpose_tiled"]
    before = kern.launches
    got = kern(bufs, grid=grid, block=64, h=h, w=w)["y"].cpu()
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(host, Dim3(grid), Dim3(64), h=h, w=w)["y"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    tile = (torch.arange(h)[:, None] // 8) * (w // 8) \
        + torch.arange(w)[None, :] // 8
    covered = (tile < grid).t()
    assert torch.equal(got[covered].view(torch.int32),
                       host["x"].t()[covered].view(torch.int32))
    assert torch.equal(got[~covered].view(torch.int32),
                       host["y"][~covered].view(torch.int32))


#: (n, nodes a CTA): the main path; n a multiple of 32 but not of 256
#: (1056 = 33 blocks of 32), of one CTA's nodes, below one CTA, one block
BFS_CTAS = tuple((n, c) for n in (1_000_000, 1056, 1024, 96, 32, 2048 + 32)
                 for c in (1024, 512, 256))


@pytest.mark.parametrize("n,cta_nodes", BFS_CTAS)
def test_bfs_frontier_ctas_cover_every_logical_block(monkeypatch, n,
                                                     cta_nodes):
    # each logical block of 32 threads (nodes) lies in a CTA below the
    # count, and the last CTA holds a node: no CTA is started for nothing
    monkeypatch.setattr(lower_cuda, "bfs_frontier_cta_nodes",
                        lambda: cta_nodes)
    ctas = lower_cuda.bfs_frontier_ctas(n)
    first = np.arange(0, n, 32)
    assert ((first + 31) // cta_nodes < ctas).all()
    assert (ctas - 1) * cta_nodes < n


#: (h, w, grid) of hotspot: the main path; a grid short of the array in
#: both axes and in one; a grid past it; sides off the CTA's region, w not
#: a multiple of 4; one tile
HOTSPOT = ((1024, 1024, (128, 128)), (40, 72, (9, 5)), (40, 72, (5, 3)),
           (40, 72, (9, 2)), (40, 72, (12, 7)), (200, 264, (33, 25)),
           (40, 70, (9, 5)), (40, 70, (4, 5)), (8, 8, (1, 1)))


@pytest.mark.parametrize("region", ((32, 128), (16, 64), (64, 32)))
@pytest.mark.parametrize("h,w,grid", HOTSPOT)
def test_hotspot_ctas_cover_the_grids_tiles(monkeypatch, h, w, grid,
                                            region):
    # every cell a logical tile writes (inside the array) lies in a CTA of
    # the physical grid, and every CTA holds such a cell.  The region
    # comes from the kernel's source on the card; here it is the shipped
    # one and two others
    monkeypatch.setattr(lower_cuda, "hotspot_region", lambda: region)
    rows, cols = region
    cx, cy = lower_cuda.hotspot_ctas(h, w, grid)
    written = np.zeros((h, w), bool)
    for by in range(grid[1]):
        for bx in range(grid[0]):
            written[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8] = True
    r, c = np.nonzero(written)
    assert (r // rows < cy).all() and (c // cols < cx).all()
    held = np.zeros((cy, cx), bool)
    held[r // rows, c // cols] = True
    assert held.all()


@pytest.mark.gpu
@pytest.mark.parametrize("n,block", ((1024, 32), (1056, 32), (1024, 64),
                                     (1056, 96)))
def test_bfs_frontier_bit_for_bit_at_every_level(card, n, block):
    # every level of a small graph, and one past the last (an empty
    # frontier), at the chevron's blocks of 32 and wider ones: the claim
    # keys come from the logical ids.  The wrapper's owner scratch is back
    # at INT_MAX after each launch
    entry = cuda_suite.entry_bfs_frontier(n=n, deg=6)
    args = entry.make_args(np.random.default_rng(42))
    dist = cuda_suite.bfs_levels(args["edges"], n)
    kern = lower_cuda.KERNELS["bfs_frontier"]
    grid, actives = n // block, []
    for level in range(int(dist.max()) + 2):
        bufs = carry.from_reference(_bfs_state(args, dist, level),
                                    device=card)
        before = kern.launches
        got = kern(bufs, grid=grid, block=block, n=n, deg=6)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        want = kern.plain(bufs, Dim3(grid), Dim3(block), n=n, deg=6)
        for k in kern.writes:
            assert torch.equal(got[k], want[k]), (level, k)
        key = lower_cuda._bfs_scratch_key(bufs, n)
        owner = lower_cuda._BFS_SCRATCH[key]["owner"]
        assert bool((owner == lower_cuda._INT_MAX).all())
        actives.append(int(got["active"][0]))
    assert actives[-1] == 0 and max(actives) > 1


@pytest.mark.gpu
def test_bfs_chain_twice_on_one_device(card):
    # the second run finds the first run's owner scratch and must see it
    # at INT_MAX: both equal the oracle bit for bit
    entry = cuda_suite.entry_bfs_frontier(n=1056, deg=6)
    for _ in range(2):
        out, want = cuda_suite.run_entry(entry, "cuda", device=card)
        for k, v in want.items():
            np.testing.assert_array_equal(out[k].cpu().numpy(), v)


@pytest.mark.gpu
def test_bfs_frontier_on_a_second_stream(card):
    # another stream gets an owner scratch of its own, and the same bits
    entry = cuda_suite.entry_bfs_frontier(n=1024, deg=6)
    args = entry.make_args(np.random.default_rng(42))
    dist = cuda_suite.bfs_levels(args["edges"], 1024)
    bufs = carry.from_reference(_bfs_state(args, dist, 3), device=card)
    kern = lower_cuda.KERNELS["bfs_frontier"]
    want = kern(bufs, grid=32, block=32, n=1024, deg=6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kern(bufs, grid=32, block=32, n=1024, deg=6)
        key = lower_cuda._bfs_scratch_key(bufs, 1024)
    torch.cuda.synchronize()
    assert key != lower_cuda._bfs_scratch_key(bufs, 1024)
    assert key in lower_cuda._BFS_SCRATCH
    for k in kern.writes:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_bfs_frontier_failed_launch_drops_its_scratch(card, monkeypatch):
    # a launch that raises may leave bids behind: its owner scratch goes,
    # and the next launch fills a new one
    entry = cuda_suite.entry_bfs_frontier(n=1024, deg=6)
    args = entry.make_args(np.random.default_rng(42))
    dist = cuda_suite.bfs_levels(args["edges"], 1024)
    bufs = carry.from_reference(_bfs_state(args, dist, 3), device=card)
    kern = lower_cuda.KERNELS["bfs_frontier"]
    want = kern(bufs, grid=32, block=32, n=1024, deg=6)
    key = lower_cuda._bfs_scratch_key(bufs, 1024)
    assert key in lower_cuda._BFS_SCRATCH

    def fail(*a, **k):
        raise RuntimeError("launch_bfs_frontier: launch failed")

    monkeypatch.setattr(_native, "launch", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        kern(bufs, grid=32, block=32, n=1024, deg=6)
    assert key not in lower_cuda._BFS_SCRATCH
    monkeypatch.undo()
    got = kern(bufs, grid=32, block=32, n=1024, deg=6)
    for k in kern.writes:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("h,w,grid", HOTSPOT)
def test_hotspot_bit_for_bit_on_the_card(card, h, w, grid, offset):
    # t_out equals the plain version's bits: the step below the grid's
    # tiles, its own input past them; buffers 4 bytes past a 16-byte
    # boundary (and w % 4 != 0) take the launcher's one-float path
    r = np.random.default_rng(42)
    host = {"t": torch.from_numpy(r.uniform(60, 100, (h, w))
                                  .astype(np.float32)),
            "p": torch.from_numpy(r.uniform(0, 1, (h, w)).astype(np.float32)),
            "t_out": torch.from_numpy(r.standard_normal((h, w), np.float32))}
    bufs = {}
    for name, t in host.items():
        flat = torch.zeros(t.numel() + 4, device=card)
        bufs[name] = flat[offset:offset + t.numel()].view(t.shape)
        bufs[name].copy_(t.to(card))
        assert bool(bufs[name].data_ptr() % 16) == bool(offset)
    params = {"h": h, "w": w, "cap": 0.5, "rx": 0.1, "ry": 0.1, "rz": 0.05,
              "amb": 80.0}
    kern = lower_cuda.KERNELS["hotspot"]
    before = kern.launches
    kern.launch_into(bufs, Dim3(*grid), Dim3(8, 8), **params)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = bufs["t_out"].cpu()
    want = kern.plain(host, Dim3(*grid), Dim3(8, 8), **params)["t_out"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    nr, nc = min(h, 8 * grid[1]), min(w, 8 * grid[0])
    kept = torch.ones(h, w, dtype=torch.bool)
    kept[:nr, :nc] = False
    assert torch.equal(got[kept].view(torch.int32),
                       host["t_out"][kept].view(torch.int32))


#: (h, w, grid) of srad_update: the main path (srad 2048 2048); a grid
#: short of the image in both axes and in one; a grid past it; sides off
#: the CTA's region, w not a multiple of 4; one tile
SRAD = ((2048, 2048, (256, 256)), (40, 72, (9, 5)), (40, 72, (5, 3)),
        (40, 72, (9, 2)), (40, 72, (12, 7)), (200, 264, (33, 25)),
        (40, 70, (9, 5)), (40, 70, (4, 5)), (8, 8, (1, 1)))


@pytest.mark.parametrize("region", ((8, 128), (16, 64), (4, 256)))
@pytest.mark.parametrize("h,w,grid", SRAD)
def test_srad_update_ctas_cover_the_grids_tiles(monkeypatch, h, w, grid,
                                                region):
    # every pixel a logical tile writes (inside the image) lies in a CTA
    # of the physical grid, and every CTA holds such a pixel.  The region
    # comes from the kernel's source on the card; here it is the shipped
    # one and two others
    monkeypatch.setattr(lower_cuda, "srad_update_region", lambda: region)
    rows, cols = region
    cx, cy = lower_cuda.srad_update_ctas(h, w, grid)
    written = np.zeros((h, w), bool)
    written[:grid[1] * 8, :grid[0] * 8] = True
    r, c = np.nonzero(written)
    assert (r // rows < cy).all() and (c // cols < cx).all()
    held = np.zeros((cy, cx), bool)
    held[r // rows, c // cols] = True
    assert held.all()


def _srad_host(h, w, order_free, rng):
    """srad_update's buffers on the host: a speckled image, y a stale
    image, and per-block partials of x and x*x (blocks of 128 pixels).
    ``order_free`` puts each total in one entry of its array, so that any
    order of the fold gives the same totals."""
    x = np.exp(0.1 * rng.standard_normal((h, w))).astype(np.float32)
    n_part = max(1, h * w // 128)
    if order_free:
        psum = np.zeros(n_part, np.float32)
        psq = np.zeros(n_part, np.float32)
        psum[n_part // 2] = x.astype(np.float64).sum()
        psq[n_part - 1] = (x.astype(np.float64) ** 2).sum()
    else:
        blocks = np.resize(x.reshape(-1), (n_part, 128))
        psum = blocks.sum(1, dtype=np.float32)
        psq = (blocks * blocks).sum(1, dtype=np.float32)
    return {"x": torch.from_numpy(x), "psum": torch.from_numpy(psum),
            "psq": torch.from_numpy(psq),
            "y": torch.from_numpy(rng.standard_normal((h, w), np.float32))}


def _on_card(host, card, offset):
    """Each buffer copied to the card, ``offset`` floats past a 16-byte
    boundary."""
    bufs = {}
    for name, t in host.items():
        flat = torch.zeros(t.numel() + 4, dtype=t.dtype, device=card)
        bufs[name] = flat[offset:offset + t.numel()].view(t.shape)
        bufs[name].copy_(t.to(card))
        assert bool(bufs[name].data_ptr() % 16) == bool(offset)
    return bufs


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("h,w,grid", SRAD)
def test_srad_update_bit_for_bit_given_order_free_totals(card, h, w, grid,
                                                         offset):
    # with totals that no order changes, y equals the plain version's
    # bits: the step below the grid's tiles, its own input past them;
    # buffers 4 bytes past a 16-byte boundary (and w % 4 != 0) take the
    # launcher's one-float paths, in the fold and in the stencil
    host = _srad_host(h, w, True, np.random.default_rng(42))
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS["srad_update"]
    before = kern.launches
    kern.launch_into(bufs, Dim3(*grid), Dim3(8, 8), h=h, w=w, lam=0.5)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = bufs["y"].cpu()
    want = kern.plain(host, Dim3(*grid), Dim3(8, 8), h=h, w=w,
                      lam=0.5)["y"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    nr, nc = min(h, 8 * grid[1]), min(w, 8 * grid[0])
    kept = torch.ones(h, w, dtype=torch.bool)
    kept[:nr, :nc] = False
    assert torch.equal(got[kept].view(torch.int32),
                       host["y"][kept].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("h,w,grid", SRAD)
def test_srad_update_within_tol_on_the_card(card, h, w, grid, offset):
    # partials of 128 pixels each: the fold's order is not torch.sum's,
    # so y holds the plain version within the entry's tolerance
    host = _srad_host(h, w, False, np.random.default_rng(7))
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS["srad_update"]
    got = kern(bufs, grid=grid, block=(8, 8), h=h, w=w, lam=0.5)["y"]
    torch.cuda.synchronize()
    want = kern.plain(host, Dim3(*grid), Dim3(8, 8), h=h, w=w,
                      lam=0.5)["y"]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


#: (nboxes, ppb, nnei, grid, wild) of lavamd: the main path (lavaMD
#: -boxes1d 10); ppb of one lane, a few, one past a warp, the main path's
#: and CUDA's widest block (neighbours staged in chunks); no neighbour,
#: one and five; grids short of nboxes; neighbour ids negative or past
#: the end (``wild``)
LAVAMD = ((1000, 100, 27, 1000, False), (64, 1, 27, 64, False),
          (64, 7, 27, 64, False), (64, 33, 27, 64, False),
          (64, 100, 27, 64, False), (24, 1024, 27, 24, False),
          (16, 33, 0, 16, False), (64, 100, 1, 64, False),
          (64, 100, 5, 64, False),
          (64, 100, 27, 37, False), (24, 1024, 27, 5, False),
          (64, 33, 27, 64, True), (40, 100, 9, 33, True),
          (16, 1024, 4, 16, True))


@pytest.mark.gpu
@pytest.mark.parametrize("nboxes,ppb,nnei,grid,wild", LAVAMD)
def test_lavamd_within_tol_on_the_card(card, nboxes, ppb, nnei, grid, wild):
    # force holds the plain version within the entry's 1e-4 over the
    # grid's home boxes, and keeps its input past them
    # the entry's inputs (its generator wants two neighbours at least)
    r = np.random.default_rng(42)
    args = cuda_suite.entry_lavamd(nboxes=nboxes, ppb=ppb,
                                   nnei=max(nnei, 2)).make_args(r)
    args["nbr"] = np.ascontiguousarray(args["nbr"][:, :nnei])
    args["force"] = r.standard_normal(nboxes * ppb).astype(np.float32)
    if wild:
        odd = np.array([-1, -5, -nboxes - 3, nboxes, nboxes + 7], np.int32)
        pick = r.random(args["nbr"].shape) < 0.3
        args["nbr"] = np.where(pick, r.choice(odd, args["nbr"].shape),
                               args["nbr"]).astype(np.int32)
    bufs = carry.from_reference(args, device=card)
    kern = lower_cuda.KERNELS["lavamd"]
    params = {"nboxes": nboxes, "ppb": ppb, "nnei": nnei, "alpha": 0.5}
    before = kern.launches
    got = kern(bufs, grid=grid, block=ppb, **params)["force"]
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(bufs, Dim3(grid), Dim3(ppb), **params)["force"]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[grid * ppb:], bufs["force"][grid * ppb:])


#: (h, w, grid) of stencil2d: the main path (4096 x 4096, the chevron's
#: (512, 512) tiles), then hotspot's shapes
STENCIL2D = ((4096, 4096, (512, 512)), *HOTSPOT)


@pytest.mark.parametrize("region", ((8, 128), (16, 64), (4, 256)))
@pytest.mark.parametrize("h,w,grid", STENCIL2D)
def test_stencil2d_ctas_cover_the_grids_tiles(monkeypatch, h, w, grid,
                                              region):
    # every cell a logical tile writes (inside the array) lies in a CTA of
    # the physical grid, and every CTA holds such a cell.  The tiles write
    # a product of rows and columns, so each axis is checked on its own.
    # The region comes from the kernel's source on the card; here it is
    # the shipped one and two others
    monkeypatch.setattr(lower_cuda, "stencil2d_region", lambda: region)
    rows, cols = region
    cx, cy = lower_cuda.stencil2d_ctas(h, w, grid)
    for n, tiles, per, ctas in ((h, grid[1], rows, cy), (w, grid[0], cols,
                                                         cx)):
        written = np.zeros(n, bool)
        for t in range(tiles):
            written[t * 8:t * 8 + 8] = True
        cells = np.nonzero(written)[0]
        assert (cells // per < ctas).all()
        assert np.array_equal(np.unique(cells // per), np.arange(ctas))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("h,w,grid", STENCIL2D)
def test_stencil2d_bit_for_bit_on_the_card(card, h, w, grid, offset):
    # y equals the plain version's bits: the stencil below the grid's
    # tiles, its own input past them; buffers 4 bytes past a 16-byte
    # boundary (and w % 4 != 0) take the launcher's one-float path
    r = np.random.default_rng(42)
    host = {"x": torch.from_numpy(r.standard_normal((h, w), np.float32)),
            "y": torch.from_numpy(r.standard_normal((h, w), np.float32))}
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS["stencil2d"]
    before = kern.launches
    kern.launch_into(bufs, Dim3(*grid), Dim3(8, 8), h=h, w=w)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = bufs["y"].cpu()
    want = kern.plain(host, Dim3(*grid), Dim3(8, 8), h=h, w=w)["y"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    nr, nc = min(h, 8 * grid[1]), min(w, 8 * grid[0])
    kept = torch.ones(h, w, dtype=torch.bool)
    kept[:nr, :nc] = False
    assert torch.equal(got[kept].view(torch.int32),
                       host["y"][kept].view(torch.int32))


#: (n, grid, block) of kmeans_assign: the main path (kmeans -o -i
#: kdd_cup); n ragged against the block; grids short of n; one point;
#: CUDA's widest block
KMEANS_CTAS = ((494080, 7720, 64), (1000, 16, 64), (1000, 10, 64),
               (2049, 33, 64), (1, 1, 32), (20000, 20, 1024),
               (4096, 64, 64))


@pytest.mark.parametrize("per", (1024, 512, 2048))
@pytest.mark.parametrize("n,grid,block", KMEANS_CTAS)
def test_kmeans_assign_ctas_cover_exactly_the_points(monkeypatch, n, grid,
                                                     block, per):
    # CTA j holds the points [j per, (j + 1) per): every point the grid
    # covers lies in one, and the last CTA holds one.  The points a CTA
    # covers come from the kernel's source on the card; here they are the
    # shipped count and two others
    monkeypatch.setattr(lower_cuda, "kmeans_assign_cta_points", lambda: per)
    ctas = lower_cuda.kmeans_assign_ctas(n, grid, block)
    m = min(n, grid * block)
    assert (np.arange(m) // per < ctas).all()
    assert (ctas - 1) * per < m


@pytest.mark.parametrize("per", (256, 32, 128))
@pytest.mark.parametrize("k", (1, 4, 32, 33, 100, 256, 257, 1000))
def test_kmeans_update_ctas_give_every_cluster_one_lane(monkeypatch, k,
                                                        per):
    # lane c of the launch takes cluster c: CTAs of up to `per` lanes
    # hold the k clusters, and the last CTA holds one.  The widest CTA
    # comes from the kernel's source on the card; here it is the shipped
    # width and two others
    monkeypatch.setattr(lower_cuda, "kmeans_update_cta_threads",
                        lambda: per)
    ctas = lower_cuda.kmeans_update_ctas(k)
    warps = -(-k // 32)
    lanes = min(warps, per // 32) * 32          # a CTA's threads
    assert ctas * lanes >= k > (ctas - 1) * lanes


def _kmeans_host(n, k, rng, held=0.5):
    """kmeans_assign's buffers: integer-valued points and centroids on a
    small grid (so distances tie often; the first two centroids are one
    point and the third lies where many points are equidistant from it
    and the first), totals below 2^24; ``held`` of the points already
    hold their answer in ``assign``, the rest a random cluster; the sums
    and counts start from integers."""
    px = rng.integers(0, 31, n).astype(np.float32)
    py = rng.integers(0, 31, n).astype(np.float32)
    cx = rng.integers(0, 31, k).astype(np.float32)
    cy = rng.integers(0, 31, k).astype(np.float32)
    if k > 2:
        cx[1], cy[1] = cx[0], cy[0]
        cx[2], cy[2] = cx[0] + 2, cy[0]
    d = (px[:, None] - cx[None]) ** 2 + (py[:, None] - cy[None]) ** 2
    answer = d.argmin(1).astype(np.int32)
    assign = np.where(rng.random(n) < held, answer,
                      rng.integers(0, k, n)).astype(np.int32)
    return {"px": px, "py": py, "cx": cx, "cy": cy, "assign": assign,
            "changed": np.full(1, 3, np.int32),
            "sumx": rng.integers(0, 9, k).astype(np.float32),
            "sumy": rng.integers(0, 9, k).astype(np.float32),
            "count": rng.integers(0, 9, k).astype(np.int32)}


#: (n, grid, block, k) of kmeans_assign on the card: the main path; n
#: ragged against the block; a grid short of n; k = 1, the largest in
#: registers (8), the first in shared bins (9) and the most (32), each
#: also with a grid short of n; CUDA's widest block
KMEANS = ((494080, 7720, 64, 4), (1000, 16, 64, 4), (1000, 10, 64, 4),
          (5000, 80, 64, 1), (5000, 80, 64, 8), (5000, 80, 64, 9),
          (5000, 80, 64, 32), (5000, 40, 64, 1), (5000, 40, 64, 32),
          (20000, 20, 1024, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("n,grid,block,k", KMEANS)
def test_kmeans_assign_bit_for_bit_on_the_card(card, n, grid, block, k):
    # every written buffer equals the plain version's bits: assign below
    # m = min(n, grid block) and its input past it, the moved points
    # counted against the input assign, sums and counts added on
    host = _kmeans_host(n, k, np.random.default_rng(42))
    bufs = carry.from_reference(host, device=card)
    kern = lower_cuda.KERNELS["kmeans_assign"]
    before = kern.launches
    got = kern(bufs, grid=grid, block=block, n=n, k=k)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(carry.from_reference(host, device="cpu"), Dim3(grid),
                      Dim3(block), n=n, k=k)
    for name in kern.writes:
        assert torch.equal(got[name].cpu(), want[name]), name
    m = min(n, grid * block)
    assert np.array_equal(got["assign"][m:].cpu().numpy(),
                          host["assign"][m:])
    if k > 1:      # with one cluster every answer is 0 and none moves
        assert 3 < int(got["changed"][0]) < 3 + m


@pytest.mark.gpu
@pytest.mark.parametrize("k", (3, 9))
def test_kmeans_assign_ties_go_to_the_lower_centre_on_the_card(card, k):
    # centroids 0 and 1 coincide, and 2 lies 2 to the right of them: a
    # point at the one position or one to the right of it ties, and goes
    # to centroid 0
    host = _kmeans_host(256, k, np.random.default_rng(3))
    cx0, cy0 = host["cx"][0], host["cy"][0]
    host["px"][:128] = cx0 + np.arange(128) % 2
    host["py"][:128] = cy0
    bufs = carry.from_reference(host, device=card)
    got = lower_cuda.KERNELS["kmeans_assign"](bufs, grid=4, block=64, n=256,
                                              k=k)["assign"].cpu().numpy()
    d = ((host["px"][:, None] - host["cx"][None]) ** 2
         + (host["py"][:, None] - host["cy"][None]) ** 2)
    assert np.array_equal(got, d.argmin(1))
    assert (got[:128] == 0).all()


#: (n, grid, block) of scan_block: the main path, grids short of n and a
#: ragged n, then every block it admits at a ragged n, its grid whole
SCAN = ((1 << 24, 131072, 128), (40003, 100, 128), (40003, 7, 1024),
        (1000, 7, 128), *((4101, 4101 // b, b) for b in
                          (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,grid,block", SCAN)
def test_scan_block_ctas_cover_the_blocks(n, grid, block):
    # the launcher runs thread j of the logical grid on warp j // max(block,
    # 32) (a warp a block, or 32 / block blocks a warp below 32), 8 warps a
    # CTA: every thread lies in a CTA of the count chip_smoke.py prints,
    # and every CTA holds one
    ctas = _chip_smoke().warp_block_ctas(grid, block)
    cta = np.arange(grid * block, dtype=np.int64) // max(block, 32) // 8
    assert (cta < ctas).all()
    assert np.array_equal(np.unique(cta), np.arange(ctas))


#: (n, grid, block) of stencil1d: the main path; ragged n; blocks of 1,
#: 96 and 1024; grids short of n (m = 3999 ends inside a lane's four)
STENCIL1D = ((1 << 24, 131072, 128), (4000, 32, 128), (4001, 4001, 1),
             (4003, 42, 96), (4000, 4, 1024), (4003, 3, 1024),
             (4001, 30, 128), (4000, 41, 96), (4000, 3999, 1))


@pytest.mark.parametrize("per", (1024, 512, 2048))
@pytest.mark.parametrize("n,grid,block", STENCIL1D)
def test_stencil1d_ctas_cover_the_elements(monkeypatch, n, grid, block,
                                           per):
    # CTA j covers the elements [j per, (j + 1) per): every element below
    # m = min(n, grid block) lies in a CTA of the physical grid, and every
    # CTA holds one.  The elements a CTA covers come from the kernel's
    # source on the card; here they are the shipped count and two others
    monkeypatch.setattr(lower_cuda, "stencil1d_cta_elems", lambda: per)
    ctas = lower_cuda.stencil1d_ctas(n, grid, block)
    cta = np.arange(min(n, grid * block), dtype=np.int64) // per
    assert (cta < ctas).all()
    assert np.array_equal(np.unique(cta), np.arange(ctas))


#: (n, grid, block) of needle_nw: the main path's n = 2048 (the chevron's
#: n / 16 blocks of 16), small and ragged n, grids short of n and wider
#: than it, and blocks of 1, 48 and 1024
NEEDLE_NW = ((2048, 128, 16), (16, 1, 16), (48, 3, 16), (100, 7, 16),
             (100, 4, 16), (64, 64, 1), (48, 1, 48), (2048, 2, 1024))


@pytest.mark.parametrize("per", (128, 256, 96))
@pytest.mark.parametrize("n,grid,block", NEEDLE_NW)
def test_needle_nw_ctas_give_every_cell_one_thread(monkeypatch, n, grid,
                                                   block, per):
    # thread t of the logical grid is thread t % per of CTA t // per, and
    # keeps cell t of the diagonal: on every diagonal (and one out of
    # range) each cell the plain version writes has exactly one thread of
    # the physical grid, no thread writes another, and every CTA holds a
    # thread of the logical grid
    monkeypatch.setattr(lower_cuda, "needle_nw_cta_threads", lambda: per)
    ctas = lower_cuda.needle_nw_ctas(grid, block)
    t = np.arange(ctas * per)
    live = t < grid * block
    assert np.array_equal(np.unique(t[live] // per), np.arange(ctas))
    for d in (*range(2, 2 * n + 1), 0, 2 * n + 1):
        lo, hi = max(1, d - n), min(n, d - 1)
        i = t[live & (t <= hi - lo)] + lo      # row i, column d - i
        want = np.arange(lo, min(hi, lo + grid * block - 1) + 1)
        assert np.array_equal(i, want), d


#: (cols, grid, block) of pathfinder: the main path's 100,000 columns,
#: ragged and tiny rows, and grids short of cols (the chevron's block is
#: always 64, the check's rule)
PATHFINDER = ((100_000, 1563, 64), (100_003, 1563, 64), (1, 1, 64),
              (63, 1, 64), (64, 1, 64), (65, 2, 64), (100_000, 7, 64),
              (4000, 40, 64), (1025, 17, 64))


@pytest.mark.parametrize("per", (1024, 512, 2048))
@pytest.mark.parametrize("cols,grid,block", PATHFINDER)
def test_pathfinder_ctas_cover_the_columns(monkeypatch, cols, grid, block,
                                           per):
    # CTA j covers the columns [j per, (j + 1) per): every column below
    # m = min(cols, grid block) lies in a CTA of the physical grid, once,
    # and every CTA holds one.  The columns a CTA covers come from the
    # kernel's source on the card; here they are the shipped count and
    # two others
    monkeypatch.setattr(lower_cuda, "pathfinder_cta_cols", lambda: per)
    ctas = lower_cuda.pathfinder_ctas(cols, grid, block)
    m = min(cols, grid * block)
    owner = np.arange(ctas * per) // per
    cta = owner[:m]
    assert ctas * per >= m > (ctas - 1) * per
    assert np.array_equal(np.unique(cta), np.arange(ctas))


def _floats(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n, np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("shape", ("main", "one", "short"))
@pytest.mark.parametrize("block", (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                   1024))
def test_scan_block_bit_for_bit_on_the_card(card, block, shape, offset):
    # y equals the plain version's bits below grid * block and keeps its
    # input past it, at the main path's n = 2^24 (grid n / block), one
    # block, and a grid short of a ragged n; buffers aligned to 16 bytes
    # and 4 bytes past it
    n = 1 << 24 if shape == "main" else 40003
    grid = {"main": n // block, "one": 1, "short": n // block // 3}[shape]
    host = {"x": _floats(n, 42), "y": _floats(n, 43)}
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS["scan_block"]
    before = kern.launches
    kern.launch_into(bufs, Dim3(grid), Dim3(block), n=n, nthreads=block)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = bufs["y"].cpu()
    want = kern.plain(host, Dim3(grid), Dim3(block), n=n,
                      nthreads=block)["y"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    m = grid * block
    assert torch.equal(got[m:].view(torch.int32),
                       host["y"][m:].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("n,grid,block", STENCIL1D)
def test_stencil1d_bit_for_bit_on_the_card(card, n, grid, block, offset):
    # y equals the plain version's bits: the stencil below m = min(n,
    # grid block), its own input past m; buffers aligned to 16 bytes and
    # 4 bytes past it
    host = {"x": _floats(n, 42), "y": _floats(n, 43)}
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS["stencil1d"]
    before = kern.launches
    kern.launch_into(bufs, Dim3(grid), Dim3(block), n=n, nthreads=block)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    got = bufs["y"].cpu()
    want = kern.plain(host, Dim3(grid), Dim3(block), n=n,
                      nthreads=block)["y"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    m = min(n, grid * block)
    assert torch.equal(got[m:].view(torch.int32),
                       host["y"][m:].view(torch.int32))


#: (n, grid, block) of pixel_pipeline: the main path; blocks of 1, 33
#: (m = grid block not a multiple of 4) and 1024; grids short of n
PIXEL = ((1 << 24, 131072, 128), (4000, 4000, 1), (4029, 1221, 33),
         (4029, 1001, 33), (4000, 31, 128), (40960, 40, 1024),
         (40000, 39, 1024))


@pytest.mark.parametrize("per", (1024, 512, 2048))
@pytest.mark.parametrize("n,grid,block", PIXEL)
def test_pixel_pipeline_ctas_cover_the_elements(monkeypatch, n, grid, block,
                                                per):
    # CTA j covers the elements [j per, (j + 1) per): every element below
    # m = grid block lies in a CTA of the physical grid, and every CTA
    # holds one.  The elements a CTA covers come from the kernel's source
    # on the card; here they are the shipped count and two others
    monkeypatch.setattr(lower_cuda, "pixel_pipeline_cta_elems", lambda: per)
    ctas = lower_cuda.pixel_pipeline_ctas(n, grid, block)
    cta = np.arange(min(n, grid * block), dtype=np.int64) // per
    assert (cta < ctas).all()
    assert np.array_equal(np.unique(cta), np.arange(ctas))


def _pixels(n, seed):
    """pixel_pipeline's img as the entry draws it, in [0.5, 2)."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.5, 2.0, n).astype(np.float32))


def _pixel_on_the_card(card, n, grid, block, offset):
    """out after one launch over img and an out of NaNs, ``offset``
    floats past a 16-byte boundary, and the launch's parameters."""
    host = {"img": _pixels(n, 42), "out": torch.full((n,), torch.nan)}
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS["pixel_pipeline"]
    params = {"n": n, "nthreads": block, "c0": 0.85, "c1": 0.1}
    before = kern.launches
    kern.launch_into(bufs, Dim3(grid), Dim3(block), **params)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    return bufs, params


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("n,grid,block", PIXEL)
def test_pixel_pipeline_within_tol_on_the_card(card, n, grid, block, offset):
    # out within the entry's 2e-5 of the plain version below m = grid
    # block, and its NaNs untouched past m
    bufs, params = _pixel_on_the_card(card, n, grid, block, offset)
    kern = lower_cuda.KERNELS["pixel_pipeline"]
    want = kern.plain(bufs, Dim3(grid), Dim3(block), **params)["out"]
    m = grid * block
    got = bufs["out"]
    torch.testing.assert_close(got[:m], want[:m], rtol=2e-5, atol=2e-5)
    assert torch.isnan(got[m:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n,grid,block", PIXEL)
def test_pixel_pipeline_bits_do_not_depend_on_the_offset(card, n, grid,
                                                         block):
    # the arithmetic per element does not depend on where the element
    # lies: buffers on a 16-byte boundary and 4 bytes past it give the
    # same bits
    got = [_pixel_on_the_card(card, n, grid, block, offset)[0]["out"].cpu()
           for offset in (0, 1)]
    assert torch.equal(got[0].view(torch.int32), got[1].view(torch.int32))


#: (n, total_threads, grid, block) of the histogram: G = grid block equal
#: to T (the main path's shape, scaled down), short of it, and past it
#: (pixels counted twice); n ragged against T; T not a multiple of 4,
#: with G short of, equal to and past it; n < T
HIST_CTAS = ((1 << 20, 16384, 64, 256), (1 << 20, 16384, 5, 256),
             (10000, 1000, 10, 256), (10007, 2048, 8, 256),
             (10000, 1001, 3, 256), (10000, 1001, 7, 143),
             (5003, 333, 3, 256), (1000, 4096, 16, 256))


@pytest.mark.parametrize("layout", ("coalesced", "contiguous"))
@pytest.mark.parametrize("per", (1024, 4096, 65536))
@pytest.mark.parametrize("n,total_threads,grid,block", HIST_CTAS)
def test_histogram_ctas_cover_the_threads_pixels(monkeypatch, n,
                                                 total_threads, grid, block,
                                                 per, layout):
    # CTA b counts [a, min(a + per, end)) for a = r stride + c per, c = b
    # % chunks, of run r = b // chunks, as the launcher does: the pixels
    # of all CTAs, with multiplicity, are those the plain version's
    # threads count (a histogram of x = arange(n) into n bins), and the
    # last chunk of the longest run holds a pixel.  The pixels a CTA
    # counts come from the kernel's source on the card; here they are the
    # shipped count and two others
    monkeypatch.setattr(lower_cuda, "histogram_cta_pixels", lambda: per)
    count, stride, length = lower_cuda.histogram_runs(
        n, total_threads, grid, block, layout)
    ctas = lower_cuda.histogram_ctas(n, total_threads, grid, block, layout)
    chunks = ctas // count
    assert ctas == count * chunks and (chunks - 1) * per < length
    pixels = []
    for b in range(ctas):
        r, c = divmod(b, chunks)
        end = min(r * stride + length, n)
        a = r * stride + c * per
        pixels.append(np.arange(a, min(a + per, end)))
    got = np.bincount(np.concatenate(pixels), minlength=n)
    kern = lower_cuda.KERNELS[f"histogram_{layout}"]
    want = kern.plain({"x": torch.arange(n, dtype=torch.int32),
                       "hist": torch.zeros(n, dtype=torch.int32)},
                      Dim3(grid), Dim3(block), n=n, nbins=n,
                      total_threads=total_threads)["hist"]
    assert np.array_equal(got, want.numpy())


#: (n, total_threads, grid, block) of the histogram on the card: the main
#: path's shape scaled down (G = T), a short grid, and G > T with T not a
#: multiple of 4 and n ragged against it
HIST = {"main": (1 << 20, 16384, 64, 256), "short": (1 << 20, 16384, 5, 256),
        "wide": (100003, 1001, 16, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("nbins", (1, 256, lower_cuda.HISTOGRAM_MAX_BINS))
@pytest.mark.parametrize("shape", tuple(HIST))
@pytest.mark.parametrize("layout", ("coalesced", "contiguous"))
def test_histogram_bit_for_bit_on_the_card(card, layout, shape, nbins,
                                           offset):
    # hist equals the plain version's bits: its input plus the counts of
    # the pixels the reference's threads count, drawn from [-2 nbins, 2
    # nbins) so that some wrap once and some are dropped; x on a 16-byte
    # boundary and 4 bytes past it
    n, total_threads, grid, block = HIST[shape]
    rng = np.random.default_rng(42)
    host = {"x": torch.from_numpy(
                rng.integers(-2 * nbins, 2 * nbins, n).astype(np.int32)),
            "hist": torch.from_numpy(
                rng.integers(0, 9, nbins).astype(np.int32))}
    bufs = _on_card(host, card, offset)
    kern = lower_cuda.KERNELS[f"histogram_{layout}"]
    params = {"n": n, "nbins": nbins, "total_threads": total_threads}
    before = kern.launches
    kern.launch_into(bufs, Dim3(grid), Dim3(block), **params)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(host, Dim3(grid), Dim3(block), **params)["hist"]
    assert torch.equal(bufs["hist"].cpu(), want)


#: (n, grid, block) of streamcluster: the main path (sc_gpu's 65,536
#: points, 1,024 blocks of 64); n ragged against the grid; grids short of
#: n; one point; blocks of 32 and 1024
SC_CTAS = ((65536, 1024, 64), (1000, 16, 64), (1000, 10, 64),
           (2049, 33, 64), (1, 1, 32), (5000, 157, 32), (20000, 20, 1024))


@pytest.mark.parametrize("per", (256, 512, 1024, 2048))
@pytest.mark.parametrize("n,grid,block", SC_CTAS)
def test_streamcluster_ctas_cover_exactly_the_points(monkeypatch, n, grid,
                                                     block, per):
    # CTA j holds the points [j per, (j + 1) per): every point the grid
    # covers lies in one, and every CTA holds one.  The points a CTA
    # covers come from the kernel's source on the card; here they are 1
    # to 8 points a thread of a CTA of 256
    monkeypatch.setattr(lower_cuda, "streamcluster_cta_points", lambda: per)
    ctas = lower_cuda.streamcluster_ctas(n, grid, block)
    cta = np.arange(min(n, grid * block), dtype=np.int64) // per
    assert (cta < ctas).all()
    assert np.array_equal(np.unique(cta), np.arange(ctas))


@pytest.mark.parametrize("most,widest",
                         ((8, 256), (4, 256), (16, 256), (8, 128), (16, 128)))
@pytest.mark.parametrize("in_n", tuple(1 << e for e in range(17)))
def test_backprop_layer_ctas_give_each_unit_a_cluster(monkeypatch, in_n,
                                                      most, widest):
    # each of the grid's units runs on a cluster of C CTAs: the largest
    # power of two up to the largest cluster that leaves every CTA whole
    # warps, one CTA below 64 inputs; its T threads fill CTAs of at most
    # the widest CTA, at most one input a thread, whole warps from 32
    # inputs up, and at most 64 inputs a thread.  The shipped cluster and
    # width first, then others whose product is 1024 or more
    monkeypatch.setattr(lower_cuda, "BACKPROP_CLUSTER", most)
    monkeypatch.setattr(lower_cuda, "BACKPROP_CTA_THREADS", widest)
    for grid in (16, 3):
        ctas, c = lower_cuda.backprop_layer_ctas(in_n, grid)
        assert ctas == grid * c
    assert c & (c - 1) == 0 and in_n % c == 0
    threads = lower_cuda.backprop_layer_threads(in_n)
    per = threads // c
    assert threads == c * per and per <= widest and threads <= in_n
    assert in_n // threads <= lower_cuda.BACKPROP_MAX_PER_THREAD
    if in_n >= 32:
        assert c == min(most, in_n // 32) and per % 32 == 0
        assert per == min(widest, in_n // c)
    else:
        assert c == 1 and threads == in_n


def _sc_host(n, k, rng, dirty=False, wild=False):
    """streamcluster's buffers as the entry draws them (coordinates in
    [0, 100), assign in [0, k)), with gain, csave, ndirty and switched
    starting from values the launch must add to or keep; ``dirty``: half
    the flags already set; ``wild``: a tenth of assign at -1 and k + 3."""
    assign = rng.integers(0, k, n).astype(np.int32)
    if wild:
        pick = rng.random(n) < 0.1
        assign[pick] = np.where(rng.random(int(pick.sum())) < 0.5, -1, k + 3)
    return {"px": rng.integers(0, 100, n).astype(np.int32),
            "py": rng.integers(0, 100, n).astype(np.int32),
            "cx": rng.integers(0, 100, k).astype(np.int32),
            "cy": rng.integers(0, 100, k).astype(np.int32),
            "cand": rng.integers(0, 100, 2).astype(np.int32),
            "assign": assign,
            "gain": np.full(1, 7, np.int32),
            "csave": rng.integers(0, 9, k).astype(np.int32),
            "dirty": ((rng.random(k) < 0.5) if dirty
                      else np.zeros(k, bool)).astype(np.int32),
            "ndirty": np.full(1, 3, np.int32),
            "switched": rng.integers(0, 2, n).astype(np.int32)}


#: (n, grid, block, k, dirty, wild) of streamcluster on the card: the main
#: path, also with flags set and assign outside [0, k); n ragged against
#: the grid; a grid short of n; k = 1; the last k in shared bins and the
#: first past them (also with a short grid); blocks of 32 and 1024
SC = ((65536, 1024, 64, 20, False, False), (65536, 1024, 64, 20, True, True),
      (1000, 16, 64, 20, False, False), (1000, 10, 64, 20, False, False),
      (5000, 80, 64, 1, False, False), (5000, 80, 64, 1, True, True),
      (20000, 320, 64, 1024, True, True), (20000, 320, 64, 1025, True, True),
      (20000, 200, 64, 1025, False, False), (5000, 157, 32, 20, True, False),
      (20000, 20, 1024, 20, True, False))


@pytest.mark.gpu
@pytest.mark.parametrize("n,grid,block,k,dirty,wild", SC)
def test_streamcluster_bit_for_bit_on_the_card(card, n, grid, block, k,
                                               dirty, wild):
    # every written buffer equals the plain version's bits: gain and csave
    # added on, only the centres whose flag was 0 counted in ndirty,
    # switched set below m = min(n, grid block) and kept past it
    host = _sc_host(n, k, np.random.default_rng(42), dirty, wild)
    bufs = carry.from_reference(host, device=card)
    kern = lower_cuda.KERNELS["streamcluster"]
    before = kern.launches
    got = kern(bufs, grid=grid, block=block, n=n, k=k)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(carry.from_reference(host, device="cpu"), Dim3(grid),
                      Dim3(block), n=n, k=k)
    for name in kern.writes:
        assert torch.equal(got[name].cpu(), want[name]), name
    m = min(n, grid * block)
    assert np.array_equal(got["switched"][m:].cpu().numpy(),
                          host["switched"][m:])
    assert int(got["ndirty"][0]) > 3 or (dirty and k == 1)


#: (in_n, out_n, grid) of backprop_layer on the card: every T / C from one
#: warp a CTA up, 4 to 64 inputs a thread, and a grid short of out_n
BACKPROP = ((32, 16, 16), (64, 16, 16), (1024, 16, 16), (4096, 16, 16),
            (65536, 16, 16), (4096, 16, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("in_n,out_n,grid", BACKPROP)
def test_backprop_layer_on_clusters_on_the_card(card, in_n, out_n, grid):
    # w_out equals the plain version's bits and hidden lies within the
    # entry's tol; the units past the grid keep their input
    entry = cuda_suite.entry_backprop_layer(in_n=in_n, out_n=out_n)
    host = entry.make_args(np.random.default_rng(42))
    rng = np.random.default_rng(7)
    host["hidden"] = rng.standard_normal(out_n, dtype=np.float32)
    host["w_out"] = rng.standard_normal((out_n, in_n), dtype=np.float32)
    bufs = carry.from_reference(host, device=card)
    kern = lower_cuda.KERNELS["backprop_layer"]
    params = {"in_n": in_n, "out_n": out_n, "lr": 0.3}
    before = kern.launches
    got = kern(bufs, grid=grid, block=in_n, **params)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(bufs, Dim3(grid), Dim3(in_n), **params)
    assert torch.equal(got["w_out"], want["w_out"])
    torch.testing.assert_close(got["hidden"], want["hidden"],
                               rtol=entry.tol, atol=entry.tol)
    assert np.array_equal(got["hidden"][grid:].cpu().numpy(),
                          host["hidden"][grid:])
    assert np.array_equal(got["w_out"][grid:].cpu().numpy(),
                          host["w_out"][grid:])
    ctas, c = lower_cuda.backprop_layer_ctas(in_n, grid)
    assert ctas == grid * c and (c > 1) == (in_n >= 64)


#: the mappings of lud_diag the CTA counts are checked under: W warps a
#: CTA, and 32 / P tiles a warp of P lanes each (packed) or one
LUD_MAPPINGS = tuple((w, packed) for w in (1, 4, 8) for packed in (True,
                                                                  False))


@pytest.mark.parametrize("grid", (1, 3, 127, 128, 129, 1000))
@pytest.mark.parametrize("b", (1, 2, 5, 8, 16, 17, 31, 32))
def test_lud_diag_ctas_give_every_tile_one_segment(monkeypatch, b, grid):
    # lane l of warp w of CTA x holds row l % P of tile (x W + w) T + l // P
    # (P lanes a tile, T tiles a warp); a segment past T or a tile past the
    # grid is idle.  Every tile the grid covers sits in exactly one
    # (CTA, warp, segment), and every CTA holds one.  The tiles a CTA holds
    # come from the kernel's source on the card; here each mapping
    lanes = 1 << (b - 1).bit_length()
    for warps, packed in LUD_MAPPINGS:
        per_warp = 32 // lanes if packed else 1
        monkeypatch.setattr(lower_cuda, "lud_diag_cta_tiles",
                            lambda b, n=warps * per_warp: n)
        ctas = lower_cuda.lud_diag_ctas(b, grid)
        cta, warp, lane = np.meshgrid(np.arange(ctas), np.arange(warps),
                                      np.arange(0, 32, lanes), indexing="ij")
        seg = lane // lanes
        tile = (cta * warps + warp) * per_warp + seg
        live = (seg < per_warp) & (tile < grid)
        assert np.array_equal(np.sort(tile[live]), np.arange(grid))
        assert live.reshape(ctas, -1).any(1).all()


def _lud_run(card, a, lu, grid, b):
    """lud_diag's kernel and its plain version on the card over ``a`` and
    ``lu`` (tensors on the card), one launch of ``grid`` tiles of b."""
    kern = lower_cuda.KERNELS["lud_diag"]
    bufs = {"a": a, "lu": lu}
    params = {"ntiles": a.shape[0] // b, "b": b}
    before = kern.launches
    got = kern(bufs, grid=grid, block=b, **params)["lu"]
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.plain(bufs, Dim3(grid), Dim3(b), **params)["lu"]
    return got, want


def _assert_same_bits(got, want):
    # every value the plain version's, NaN where it is NaN, and the sign of
    # every zero
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    num = ~torch.isnan(want)
    assert torch.equal(torch.signbit(got[num]), torch.signbit(want[num]))


#: (ntiles, b, grid) of lud_diag on the card: the main path (2048.dat's 128
#: tiles of 16); every MB the launcher dispatches on, below and at it, with
#: b % 4 != 0 (one float at a time) and tiles ragged against a CTA's; grids
#: short of ntiles
LUD = ((128, 16, 128), (37, 1, 37), (37, 2, 37), (37, 5, 37), (37, 8, 37),
       (37, 16, 37), (37, 17, 37), (37, 31, 37), (37, 32, 37),
       (128, 16, 75), (40, 5, 13), (9, 32, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("ntiles,b,grid", LUD)
def test_lud_diag_bit_for_bit_on_the_card(card, ntiles, b, grid):
    # lu equals the plain version's bits on the entry's draw; the tiles
    # past the grid keep lu's input
    entry = cuda_suite.entry_lud_diag(ntiles=ntiles, b=b)
    host = entry.make_args(np.random.default_rng(42))
    host["lu"] = np.random.default_rng(7).standard_normal(
        (ntiles * b, b), dtype=np.float32)
    bufs = carry.from_reference(host, device=card)
    got, want = _lud_run(card, bufs["a"], bufs["lu"], grid, b)
    _assert_same_bits(got, want)
    assert np.array_equal(got[grid * b:].cpu().numpy(),
                          host["lu"][grid * b:])
    assert lower_cuda.lud_diag_ctas(b, grid) * \
        lower_cuda.lud_diag_cta_tiles(b) >= grid


def _lud_singular(b):
    """Four tiles of b (b >= 4) on which the reference's rule shows: a
    zero pivot at step 0; a zero pivot at step 1 (rows [1, 2, 3, 4] and
    [2, 4, 5, 1] on top); a NaN at (1, 1); and -0.0 in column 0 below row
    1, so that L keeps -0.0 there until step 1's multipliers, all
    negative, meet it."""
    r = np.random.default_rng(3)
    tiles = 0.1 * r.standard_normal((4, b, b)).astype(np.float32)
    tiles += 4.0 * np.eye(b, dtype=np.float32)
    tiles[0, 0, 0] = 0.0
    tiles[1, 0, :4] = [1, 2, 3, 4]
    tiles[1, 1, :4] = [2, 4, 5, 1]
    tiles[2, 1, 1] = np.nan
    tiles[3, 2:, 0] = -0.0
    tiles[3, 2:, 1] = -np.abs(tiles[3, 2:, 1]) - 0.5
    return tiles.reshape(4 * b, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b", (4, 16, 32))
def test_lud_diag_follows_the_reference_rule_on_singular_tiles_on_the_card(
        card, b):
    # an infinite or NaN multiplier makes the columns left of the pivot NaN
    # (s - m * 0), and -0.0 - (m * 0) is +0.0 for m < 0, as in the plain
    # version and the reference; the kernel keeps every such bit
    a = torch.from_numpy(_lud_singular(b)).to(card)
    lu = torch.zeros_like(a)
    got, want = _lud_run(card, a, lu, 4, b)
    _assert_same_bits(got, want)
    got = got.view(4, b, b).cpu()
    assert torch.isnan(got[0, 2:]).all()
    assert torch.isnan(got[1, 2:, 0]).all()
    assert torch.isnan(got[2, 2:, 0]).all()
    assert (got[3, 2:, 0] == 0).all()
    assert not torch.signbit(got[3, 2:, 0]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("b", (8, 16, 32))
def test_lud_diag_reads_a_view_off_16_bytes_on_the_card(card, b):
    # a view of a starts 4 bytes past a 16-byte boundary: the launcher
    # takes its one-float path, with the same bits
    ntiles = 37
    entry = cuda_suite.entry_lud_diag(ntiles=ntiles, b=b)
    host = entry.make_args(np.random.default_rng(42))
    store = torch.empty(ntiles * b * b + 1, device=card)
    a = store[1:].view(ntiles * b, b)
    a.copy_(torch.from_numpy(host["a"]))
    assert a.data_ptr() % 16 == 4 and a.is_contiguous()
    got, want = _lud_run(card, a, torch.zeros_like(a), ntiles, b)
    _assert_same_bits(got, want)
