"""The ``cuda`` backend's build, and its kernels on the card.

The build tests run anywhere.  The tests marked ``gpu`` need a CUDA
device and ``nvcc``; they skip elsewhere, and on a machine with a card
they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_native.py``.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch import carry
from repro_torch.core import _native, cuda_suite, lower_cuda
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import UnsupportedKernel

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
             "hotspot")


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
    # CPU), and the kernel runs them as passes of one physical block
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
