"""The routes of the hot-path matmul and flash attention, and the plain
versions of their newer kernels, against the JAX package.

``matmul.route`` and ``flash_attention.route`` pick a kernel from dtypes,
shapes and alignment alone; the tests here pin that table.  On the CPU,
``flash_decode_plain`` (the decode kernel's arithmetic: a cluster of CTAs
a kv group, their warps and ranks folded in order) is held, with its lse,
against the reference's ``ops.flash_attention(mode="interpret")`` at
``tests/test_kernels.py``'s tolerances (2e-5 float32, 2e-2 bfloat16), and
``flash_attention_plain``'s bfloat16 rounding of p (the tensor-core
kernel's) against the same reference, on the tensor-core kernel's tile
edges too, and each prefill walk's tile.

The tests marked ``gpu`` hold each route's kernel against its plain
version on the card (flash attention at ``flash_attention.PLAIN_TOL``,
then against the oracle at the tolerances above; matmul at 5e-2) and
count its launch; they skip elsewhere and run with ``PYTHONPATH=src
python -m pytest -q -m gpu tests/test_torch_hot_routes.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: tests/test_kernels.py's flash sweep (B, H, Hkv, Sq, Skv, d, causal)
FLASH = [(1, 4, 4, 128, 128, 64, True),
         (2, 8, 2, 256, 256, 64, True),
         (1, 4, 1, 64, 256, 128, False),
         (2, 2, 2, 1, 128, 64, False),
         (1, 6, 3, 96, 96, 32, True)]
#: FLASH's prefill shapes (its decode-shaped one takes the decode route)
PREFILL = [s for s in FLASH if s[1] // s[2] * s[3] > 8]
#: decode shapes: GQA 4:1 at three cache lengths, MQA, two causal rows
DECODE = [(2, 8, 2, 1, 1, 64, False),
          (2, 8, 2, 1, 1000, 64, False),
          (1, 8, 2, 1, 4096, 64, False),
          (2, 4, 1, 1, 300, 128, False),
          (2, 8, 2, 2, 777, 64, True)]
#: decode shapes whose plain version walks several cluster ranks and a
#: partial last tile: Skv of 1, 31, 129 and 4,097; R (the group's heads
#: times Sq) from 1 to 8; causal with Sq > 1; d of 32 to 128
DECODE_RANKS = [(1, 1, 1, 1, 1, 64, False),
                (2, 2, 1, 1, 31, 64, False),
                (1, 3, 1, 1, 129, 32, False),
                (1, 8, 1, 1, 4097, 64, False),
                (1, 5, 1, 1, 300, 128, False),
                (1, 6, 1, 1, 129, 112, False),
                (1, 7, 1, 1, 1000, 64, False),
                (1, 4, 1, 2, 129, 64, True),
                (1, 2, 2, 3, 31, 32, True),
                (1, 3, 1, 2, 1, 64, True),
                (1, 4, 1, 2, 4097, 64, True),
                (1, 4, 1, 2, 129, 112, True),
                (1, 4, 1, 2, 31, 32, True)]
#: the decode shapes whose kernel times stand in PERF.md: the hot path's
#: (B 32, H 32, Hkv 8, Skv 4,096, d 64); deepseek-moe-16b's 16 heads of
#: 128 and zamba2-7b's 32 heads of 112 over 1,024 keys; qwen2-0.5b's 16
#: heads of 64 (14 / 2 padded to 16 / 16) over 1,024 keys, one slot and
#: four
DECODE_TARGETS = [(32, 32, 8, 1, 4096, 64, False),
                  (1, 16, 16, 1, 1024, 128, False),
                  (1, 32, 32, 1, 1024, 112, False),
                  (1, 16, 16, 1, 1024, 64, False),
                  (4, 16, 16, 1, 1024, 64, False)]
#: the "simt" kernel's ragged cases: Sq and Skv off its query tile (256
#: at d = 48 and 64, 128 at d = 16, 64 at d = 128) and off the 64-key
#: tile, head widths 16, 48 and 128, causal and not, GQA
SIMT_RAGGED = [(1, 4, 1, 300, 300, 64, True), (1, 4, 2, 130, 77, 64, False),
               (1, 2, 2, 129, 260, 16, True), (1, 4, 2, 100, 333, 48, True),
               (1, 2, 1, 70, 150, 128, True), (2, 2, 1, 65, 65, 128, False)]
#: the "tc" kernel's edges: Sq and Skv one short of, on and one past its
#: kv tile (TC_KV_TILE = 128) and its query tile (192 at d <= 64, 128
#: above), causal with Sq < Skv and Sq > Skv and not, d 32 / 64 / 80 /
#: 112 / 128, GQA 1, 4 and 8
TC_EDGES = [(1, 2, 2, 127, 127, 128, True), (1, 4, 1, 128, 129, 112, True),
            (1, 8, 1, 129, 128, 80, True), (1, 4, 1, 191, 127, 32, True),
            (1, 8, 1, 192, 257, 64, True), (1, 2, 2, 193, 256, 64, False),
            (1, 4, 4, 129, 383, 128, False), (2, 8, 2, 130, 129, 32, True)]
#: the gap within which a kernel's lse holds its plain version's
#: (chip_smoke.py's LSE_TOL)
LSE_TOL = 1e-4
#: tests/test_kernels.py's matmul sweep (M, N, K, grain) and wider ones
MATMUL = [(128, 128, 128, 1), (256, 128, 64, 2), (64, 256, 128, 1),
          (72, 200, 40, 1), (1024, 1024, 4096, 1), (8192, 2048, 8192, 1)]


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _to_torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device).to(getattr(torch, dtype))
            for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_to_plain(got, want, which):
    """``got`` from the kernel of route ``which`` within its plain
    version's ``want`` at ``flash_attention.PLAIN_TOL``."""
    rtol, atol = tfa.PLAIN_TOL[which, want.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def _flash_inputs(B, H, Hkv, Sq, Skv, d, seed=7):
    return _draw(seed, (B, H, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))


def _reference_flash(arrays, dtype, causal, Sq, Skv):
    """The JAX package's Pallas kernel in interpret mode, one tile each."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    ja = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    return jops.flash_attention(*ja, causal=causal, mode="interpret",
                                q_blk=Sq, kv_blk=Skv)


def _offset_view(shape, dtype, elements=1):
    """A contiguous tensor of ``shape`` that starts ``elements`` past a
    16-byte boundary of its storage."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 16, dtype=dtype)
    return base[elements:elements + n].view(shape)


# ---- routes -----------------------------------------------------------
@pytest.mark.parametrize("dtype,M,N,K,offset,want", [
    (torch.bfloat16, 8192, 8192, 2048, 0, "tc"),     # granite's MLP
    (torch.bfloat16, 72, 200, 40, 0, "tc"),          # ragged M, N, K
    (torch.bfloat16, 1, 8, 8, 0, "tc"),
    (torch.bfloat16, 64, 60, 64, 0, "simt"),         # N % 8 != 0
    (torch.bfloat16, 64, 64, 36, 0, "simt"),         # K % 8 != 0
    (torch.bfloat16, 64, 64, 64, 1, "simt"),         # a 2-byte offset view
    (torch.bfloat16, 64, 64, 64, 8, "tc"),           # a 16-byte offset one
    (torch.float32, 8192, 8192, 2048, 0, "simt"),    # f32 in full f32
])
def test_matmul_route(dtype, M, N, K, offset, want):
    a = _offset_view((M, K), dtype, offset)
    b = torch.zeros(K, N, dtype=dtype)
    assert tmm.route(a, b) == want
    if offset:      # a b at the same offset routes the same way
        assert tmm.route(torch.zeros(M, K, dtype=dtype),
                         _offset_view((K, N), dtype, offset)) == want


@pytest.mark.parametrize("dtype,shape,offset,want", [
    # (B, H, Hkv, Sq, Skv, d)
    (torch.bfloat16, (2, 32, 8, 4096, 4096, 64), 0, "tc"),     # prefill
    (torch.bfloat16, (32, 32, 8, 1, 4096, 64), 0, "decode"),   # decode
    (torch.float32, (32, 32, 8, 1, 4096, 64), 0, "decode"),
    (torch.float32, (2, 32, 8, 4096, 4096, 64), 0, "simt"),
    (torch.bfloat16, (1, 4, 1, 2, 64, 64), 0, "decode"),       # 8 rows
    (torch.bfloat16, (1, 4, 1, 3, 64, 64), 0, "tc"),           # 12 rows
    (torch.bfloat16, (1, 8, 1, 1, 64, 64), 0, "decode"),       # MQA
    (torch.bfloat16, (1, 16, 1, 1, 64, 64), 0, "tc"),          # 16 rows
    (torch.bfloat16, (1, 4, 4, 16, 64, 80), 0, "tc"),          # d = 80
    (torch.bfloat16, (1, 4, 4, 16, 64, 20), 0, "simt"),        # d % 8
    (torch.float32, (1, 4, 4, 1, 64, 20), 0, "decode"),        # 80 bytes
    (torch.float32, (1, 4, 4, 1, 64, 18), 0, "simt"),          # 72 bytes
    (torch.bfloat16, (1, 4, 4, 16, 64, 64), 1, "simt"),        # offset q
    (torch.bfloat16, (1, 4, 4, 1, 64, 64), 1, "simt"),
    (torch.bfloat16, (1, 4, 4, 1, 0, 64), 0, "tc"),            # no keys
])
def test_flash_attention_route(dtype, shape, offset, want):
    B, H, Hkv, Sq, Skv, d = shape
    q = _offset_view((B, H, Sq, d), dtype, offset)
    k = torch.zeros(B, Hkv, Skv, d, dtype=dtype)
    assert tfa.route(q, k, k) == want
    if not offset and want != "simt" and Skv:   # a misaligned v too
        assert tfa.route(q, k, _offset_view(k.shape, dtype, 1)) == "simt"


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
def test_decode_split_gives_every_rank_whole_tiles(dtype):
    for B, Hkv, Skv, d in ((32, 8, 4096, 64), (1, 1, 1, 64), (2, 2, 1000, 64),
                           (1, 8, 100_000, 128), (1, 16, 1024, 128),
                           (1, 32, 1024, 112), (4, 16, 1024, 64),
                           (1, 1, 4097, 64), (1, 1, 129, 32), (3, 5, 31, 80)):
        parts, per = tfa.decode_split(B, Hkv, Skv, dtype, d)
        tile = tfa.DECODE_WARPS[dtype] * tfa.decode_tile(dtype, d)
        assert per % tile == 0
        # every part has keys, and the parts cover the cache
        assert (parts - 1) * per < Skv <= parts * per
        if dtype == torch.bfloat16:
            # a cluster, doubled only while the CTAs stay under one an SM
            assert parts in (1, 2, 4, 8)
            assert parts == 1 or B * Hkv * parts // 2 < tfa.DECODE_CTAS
    # the hot path's 256 groups: a CTA each over all 4,096 keys; the LM
    # path's 16 groups over 1,024 keys: 8 ranks of 128 (bfloat16, d = 64)
    assert tfa.decode_split(32, 8, 4096, torch.bfloat16, 64) == (1, 4096)
    assert tfa.decode_split(1, 16, 1024, torch.bfloat16, 64) == (8, 128)
    assert tfa.decode_split(4, 16, 1024, torch.bfloat16, 64) == (4, 256)
    assert tfa.decode_split(1, 1, 4097, torch.bfloat16, 64) == (8, 576)
    assert [tfa.decode_tile(torch.bfloat16, d) for d in (32, 64, 80, 128)] \
        == [16, 16, 16, 16]


def test_decode_split_covers_the_cache_in_whole_32s():
    # float32: the split-kv kernel's splits, a warp each
    f32 = torch.float32
    for B, Hkv, Skv in ((32, 8, 4096), (1, 1, 1), (2, 2, 1000),
                        (1, 8, 100_000)):
        nsplit, split = tfa.decode_split(B, Hkv, Skv, f32, 64)
        assert split % 32 == 0 and nsplit == -(-Skv // split)
        assert B * Hkv * nsplit <= tfa.DECODE_SPLIT_WARPS + B * Hkv
    # granite-3-2b's decode: 256 kv groups, 8 splits of 512 keys each
    assert tfa.decode_split(32, 8, 4096, f32, 64) == (8, 512)
    assert [tfa.decode_tile(f32, d) for d in (32, 64, 128)] == [16, 8, 4]


def test_ops_routes_name_launchers():
    for fn, routes in tops.ROUTES.items():
        for name in routes.values():
            assert name in tops.KERNELS
    assert set(tops.KERNELS) == {"rmsnorm", *(n for r in tops.ROUTES.values()
                                              for n in r.values())}


# ---- plain versions against the reference -------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", DECODE + DECODE_RANKS)
def test_flash_decode_plain_matches_the_reference(B, H, Hkv, Sq, Skv, d,
                                                  causal, dtype):
    arrays = _flash_inputs(B, H, Hkv, Sq, Skv, d)
    want = _reference_flash(arrays, dtype, causal, Sq, Skv)
    q, k, v = _to_torch(arrays, dtype)
    assert tfa.route(q, k, v) == "decode"
    got = tfa.flash_decode_plain(q, k, v, causal=causal, q_blk=Sq,
                                 kv_blk=Skv)
    assert got.dtype == q.dtype and got.shape == want.shape
    _close(got, want, TOL[dtype])
    # ops in interpret mode runs the routed kernel's plain version
    assert torch.equal(tops.flash_attention(q, k, v, causal=causal,
                                            q_blk=Sq, kv_blk=Skv), got)


def test_flash_decode_plain_merges_splits_the_mask_hides():
    # Sq = 2 causal over many splits: row 0 sees key 0 alone, so every
    # split past the first is hidden from it and must weigh nothing
    q, k, v = _to_torch(_flash_inputs(1, 4, 1, 2, 200, 32), "float32")
    assert tfa.decode_split(1, 1, 200, torch.float32, 32) == (7, 32)
    got = tfa.flash_decode_plain(q, k, v, causal=True, q_blk=2, kv_blk=200)
    torch.testing.assert_close(got[0, :, 0], v[0, :, 0].expand(4, 32))
    torch.testing.assert_close(got, tref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Skv,d", [(4097, 64), (129, 112), (31, 32)])
def test_flash_decode_plain_hides_ranks_and_warps_from_row_0(Skv, d, dtype):
    # the same over a cluster's ranks and warps, a partial last tile and
    # both dtypes: row 0 of each head is v's key 0 to the bit (the rest is
    # held against the reference in DECODE_RANKS' causal Sq = 2 cases)
    q, k, v = _to_torch(_flash_inputs(1, 4, 1, 2, Skv, d), dtype)
    got = tfa.flash_decode_plain(q, k, v, causal=True, q_blk=2, kv_blk=Skv)
    assert torch.equal(got[0, :, 0], v[0, :, 0].expand(4, d))


def _reference_lse(arrays, dtype, causal, H, Hkv):
    """The JAX package's logsumexp of each row, [B, H, Sq], from its
    chunked flash forward (``repro.models.attention._flash_fwd_lse``)."""
    import jax.numpy as jnp

    from repro.models import attention as jattn
    q, k, v = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)
    B, _, Sq, d = q.shape
    g = H // Hkv
    q5 = q.transpose(0, 2, 1, 3).reshape(B, Sq, Hkv, g, d)
    k4, v4 = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    _, lse = jattn._flash_fwd_lse(q5, k4, v4, causal=causal, q_chunk=Sq,
                                  kv_chunk=k.shape[2])
    return np.asarray(lse).reshape(B, H, Sq)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", DECODE_RANKS)
def test_flash_decode_plain_lse_matches_the_reference(B, H, Hkv, Sq, Skv, d,
                                                      causal, dtype):
    arrays = _flash_inputs(B, H, Hkv, Sq, Skv, d)
    q, k, v = _to_torch(arrays, dtype)
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    out, lse = tfa.flash_decode_plain(q, k, v, with_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.equal(out, tfa.flash_decode_plain(q, k, v, **kw))
    np.testing.assert_allclose(lse.numpy(),
                               _reference_lse(arrays, dtype, causal, H, Hkv),
                               rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", FLASH + TC_EDGES)
def test_flash_plain_rounds_p_to_bfloat16(B, H, Hkv, Sq, Skv, d, causal):
    arrays = _flash_inputs(B, H, Hkv, Sq, Skv, d)
    q, k, v = _to_torch(arrays, "bfloat16")
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    got = tfa.flash_attention_plain(q, k, v, **kw)
    # the same walk on the same values in float32 never rounds p (no
    # float32 call takes the tensor-core route)
    unrounded = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          **kw)
    assert tfa.route(q.float(), k.float(), v.float()) != "tc"
    # so the bfloat16 walk differs from it where its route is the
    # tensor-core kernel's, and only there (FLASH's decode-shaped case)
    assert torch.equal(got, unrounded.to(torch.bfloat16)) == \
        (tfa.route(q, k, v) != "tc")
    _close(got, _reference_flash(arrays, "bfloat16", causal, Sq, Skv),
           TOL["bfloat16"])


def test_flash_plain_walks_the_routed_kernels_tile(monkeypatch):
    # bfloat16 prefill walks the "tc" kernel's TC_KV_TILE keys a tile,
    # float32 the "simt" kernel's KV_TILE; each walk reads its own tile
    # and not the other's
    q, k, v = _to_torch(_flash_inputs(1, 4, 1, 40, 256, 64), "bfloat16")
    qf, kf, vf = q.float(), k.float(), v.float()
    assert tfa.route(q, k, v) == "tc" and tfa.route(qf, kf, vf) == "simt"
    assert (tfa.TC_KV_TILE, tfa.KV_TILE) == (128, 64)
    kw = dict(causal=False, q_blk=40, kv_blk=256)
    tc = tfa.flash_attention_plain(q, k, v, **kw)
    simt = tfa.flash_attention_plain(qf, kf, vf, **kw)
    monkeypatch.setattr(tfa, "KV_TILE", 32)
    assert torch.equal(tfa.flash_attention_plain(q, k, v, **kw), tc)
    assert not torch.equal(tfa.flash_attention_plain(qf, kf, vf, **kw), simt)
    monkeypatch.setattr(tfa, "TC_KV_TILE", 64)
    assert not torch.equal(tfa.flash_attention_plain(q, k, v, **kw), tc)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", SIMT_RAGGED)
def test_flash_plain_matches_the_reference_off_the_simt_tiles(
        B, H, Hkv, Sq, Skv, d, causal):
    # the plain version the "simt" kernel is held to, at its ragged cases
    arrays = _flash_inputs(B, H, Hkv, Sq, Skv, d)
    q, k, v = _to_torch(arrays, "float32")
    assert tfa.route(q, k, v) == "simt"
    got = tfa.flash_attention_plain(q, k, v, causal=causal, q_blk=Sq,
                                    kv_blk=Skv)
    _close(got, _reference_flash(arrays, "float32", causal, Sq, Skv),
           TOL["float32"])


# ---- on the card ------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launch_once(name, call):
    """``call()``; the kernel ``name`` launched once, and no other."""
    before = {n: k.launches for n, k in tops.KERNELS.items()}
    out = call()
    torch.cuda.synchronize()
    before[name] += 1
    assert {n: k.launches for n, k in tops.KERNELS.items()} == before
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,grain", MATMUL)
def test_tc_matmul_matches_its_plain_version(card, M, N, K, grain):
    a, b = _to_torch(_draw(9, (M, K), (K, N)), "bfloat16", card)
    assert tmm.route(a, b) == "tc"
    blk = 8 if M == 72 else 64
    kw = dict(bm=blk, bn=blk, bk=blk, grain=grain)
    got = _launch_once("matmul_tc", lambda: tops.matmul(a, b, **kw))
    want = tmm.matmul_plain(a, b, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _close(got, want.float().cpu().numpy(), 5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,offset", [(64, 60, 64, 0), (64, 64, 64, 1)])
def test_matmul_shapes_tma_cannot_take_run_the_simt_kernel(card, M, N, K,
                                                           offset):
    # N % 8 != 0, and a view 2 bytes past the allocation's start
    a = torch.empty(M * K + 16, dtype=torch.bfloat16, device=card)[
        offset:offset + M * K].view(M, K)
    a.copy_(_to_torch(_draw(9, (M, K)), "bfloat16")[0])
    b = _to_torch(_draw(10, (K, N)), "bfloat16", card)[0]
    assert tmm.route(a, b) == "simt"
    got = _launch_once("matmul", lambda: tops.matmul(a, b, bm=M, bn=N,
                                                     bk=K))
    _close(got, tmm.matmul_plain(a, b, bm=M, bn=N, bk=K).float().cpu()
           .numpy(), 5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal,with_lse", [
    (*s, False) for s in PREFILL + [
        (1, 4, 1, 100, 300, 64, True),  # Sq < Skv: top-left, not bottom-right
        (1, 4, 1, 300, 100, 64, True),  # Sq > Skv
        (2, 4, 2, 128, 128, 32, True), (2, 4, 2, 128, 128, 64, False),
        (1, 4, 1, 80, 70, 80, True), (1, 4, 1, 80, 70, 128, True)]]
    + [(*s, True) for s in TC_EDGES])
def test_tc_prefill_matches_its_plain_version(card, B, H, Hkv, Sq, Skv, d,
                                              causal, with_lse):
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), "bfloat16",
                        card)
    assert tfa.route(q, k, v) == "tc"
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv, with_lse=with_lse)
    got = _launch_once("flash_attention_tc",
                       lambda: tops.flash_attention(q, k, v, **kw))
    want = tfa.flash_attention_plain(q, k, v, **kw)
    if with_lse:
        (got, lse), (want, want_lse) = got, want
        assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
        assert float((lse - want_lse).abs().max()) <= LSE_TOL
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    _close_to_plain(got, want, "tc")
    _close(got, tref.flash_attention_ref(q, k, v, causal=causal).float()
           .cpu().numpy(), TOL["bfloat16"])


@pytest.mark.gpu
def test_tc_prefill_with_no_keys_writes_zeros(card):
    # Skv = 0 (the wrappers refuse it, as the reference's does: its kv
    # tile clamps to 0): the launcher encodes no map over the empty k and
    # v, and every row is 0 with the plain version's lse of a row that saw
    # no key, -1e30 + ln 1e-30 in float32
    q = _to_torch(_draw(3, (1, 4, 70, 64)), "bfloat16", card)[0]
    kv = torch.empty(1, 1, 0, 64, dtype=torch.bfloat16, device=card)
    out = torch.full_like(q, float("nan"))
    lse = torch.empty(1, 4, 70, device=card)
    _launch_once("flash_attention_tc", lambda: tfa.KERNEL_TC(
        q.data_ptr(), kv.data_ptr(), kv.data_ptr(), out.data_ptr(), 1, 4, 1,
        70, 0, 64, 1, 0.125, tfa.TC_KV_TILE, lse.data_ptr(), device=card))
    assert torch.equal(out, torch.zeros_like(q))
    assert torch.equal(lse, torch.full_like(lse, -1e30))


@pytest.mark.gpu
def test_tc_prefill_ragged_tile_reads_no_other_heads_rows(card):
    # batch 0's last kv tile holds keys 128..255 of which 2 exist: mapped as
    # [B Hkv, Skv, d] its other rows arrive as TMA's zeros; a 2-D map would
    # read batch 1's first 126 rows, whose inf v would turn the masked keys'
    # p = 0 into NaN.  Sq = 100 is ragged too (its tile's other rows would
    # be batch 0's next head's)
    B, H, Hkv, Sq, Skv, d = 2, 4, 1, 100, 130, 64
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), "bfloat16",
                        card)
    v[1] = float("inf")
    kw = dict(causal=False, q_blk=Sq, kv_blk=Skv)
    got = _launch_once("flash_attention_tc",
                       lambda: tops.flash_attention(q, k, v, **kw))[:1]
    q0, k0, v0 = q[:1], k[:1], v[:1]
    assert torch.isfinite(got).all()
    _close_to_plain(got, tfa.flash_attention_plain(q0, k0, v0, **kw), "tc")
    _close(got, tref.flash_attention_ref(q0, k0, v0, causal=False).float()
           .cpu().numpy(), TOL["bfloat16"])


@pytest.mark.gpu
def test_tc_launcher_refuses_another_kv_tile(card):
    # the plain version walks TC_KV_TILE keys a tile: a launch asked for
    # any other never runs
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16, device=card)
    before = tops.KERNELS["flash_attention_tc"].launches
    for tile in (tfa.KV_TILE, tfa.TC_KV_TILE * 2):
        with pytest.raises(RuntimeError, match="launch_flash_attention_tc"):
            tfa.KERNEL_TC(*(q.data_ptr(),) * 4, 1, 4, 4, 64, 64, 64, 1,
                          0.125, tile, None, device=card)
    assert tops.KERNELS["flash_attention_tc"].launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", DECODE + [
    (2, 2, 2, 1, 128, 64, False), (32, 32, 8, 1, 4096, 64, False),
    (1, 8, 1, 1, 500, 80, True), (2, 8, 2, 2, 128, 32, True)]
    + DECODE_RANKS + DECODE_TARGETS[1:])
def test_decode_matches_its_plain_version(card, B, H, Hkv, Sq, Skv, d,
                                          causal, dtype):
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), dtype, card)
    assert tfa.route(q, k, v) == "decode"
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    got = _launch_once("flash_decode",
                       lambda: tops.flash_attention(q, k, v, **kw))
    want = tfa.flash_decode_plain(q, k, v, **kw)
    assert got.dtype == q.dtype and torch.isfinite(got).all()
    _close_to_plain(got, want, "decode")
    _close(got, tref.flash_attention_ref(q, k, v, causal=causal).float()
           .cpu().numpy(), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal",
                         DECODE_RANKS + DECODE_TARGETS)
def test_decode_lse_matches_its_plain_version(card, B, H, Hkv, Sq, Skv, d,
                                              causal, dtype):
    # one launch writes out and lse; out is the same bits as without lse
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), dtype, card)
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    got, lse = _launch_once("flash_decode", lambda: tops.flash_attention(
        q, k, v, with_lse=True, **kw))
    want, want_lse = tfa.flash_decode_plain(q, k, v, with_lse=True, **kw)
    assert lse.dtype == torch.float32 and torch.isfinite(lse).all()
    _close_to_plain(got, want, "decode")
    torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)
    assert torch.equal(got, tops.flash_attention(q, k, v, **kw))


@pytest.mark.gpu
def test_decode_launcher_refuses_layouts_the_plain_version_does_not_walk(
        card):
    # the plain version walks decode_split's parts and decode_tile's keys:
    # a launch asked for any other layout never runs
    before = tops.KERNELS["flash_decode"].launches
    # bfloat16: a cluster's ranks
    q = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16, device=card)
    k = torch.zeros(1, 1, 1000, 64, dtype=torch.bfloat16, device=card)
    tile = tfa.decode_tile(torch.bfloat16, 64)
    cluster, per = tfa.decode_split(1, 1, 1000, torch.bfloat16, 64)
    assert (cluster, per, tile) == (8, 128, 16)
    for c, p, t in ((8, 128, 8), (8, 128, 32),      # another warp tile
                    (8, 96, 16),                    # a part of a tile
                    (4, 128, 16),                   # ranks short of Skv
                    (16, 64, 16), (3, 384, 16),     # no such cluster
                    (4, 512, 16)):                  # an idle rank
        with pytest.raises(RuntimeError, match="launch_flash_decode"):
            tfa.KERNEL_DECODE(q.data_ptr(), k.data_ptr(), k.data_ptr(),
                              q.data_ptr(), None, None, None, 1, 4, 1, 1,
                              1000, 64, 0, 0.125, c, p, t, 1, None,
                              device=card)
    # float32: the split-kv kernel's splits, and its scratch
    qf, kf = q.float(), k.float()
    ftile = tfa.decode_tile(torch.float32, 64)
    nsplit, split = tfa.decode_split(1, 1, 1000, torch.float32, 64)
    assert (nsplit, split, ftile) == (32, 32, 8)
    rows = 4 * nsplit
    pm, pl = (torch.empty(rows, device=card) for _ in range(2))
    pa = torch.empty(rows, 64, device=card)
    scratch = (pm.data_ptr(), pl.data_ptr(), pa.data_ptr())
    for n, p, t, sc in ((32, 32, 16, scratch),      # another warp tile
                        (21, 48, 8, scratch),       # a split of 32s
                        (31, 32, 8, scratch),       # splits short of Skv
                        (33, 32, 8, scratch),       # an empty split
                        (32, 32, 8, (None,) * 3)):  # no scratch
        with pytest.raises(RuntimeError, match="launch_flash_decode"):
            tfa.KERNEL_DECODE(qf.data_ptr(), kf.data_ptr(), kf.data_ptr(),
                              qf.data_ptr(), *sc, 1, 4, 1, 1, 1000, 64, 0,
                              0.125, n, p, t, 0, None, device=card)
    assert tops.KERNELS["flash_decode"].launches == before
    # and the launcher's own layouts run
    tfa.KERNEL_DECODE(q.data_ptr(), k.data_ptr(), k.data_ptr(), q.data_ptr(),
                      None, None, None, 1, 4, 1, 1, 1000, 64, 0, 0.125,
                      cluster, per, tile, 1, None, device=card)
    tfa.KERNEL_DECODE(qf.data_ptr(), kf.data_ptr(), kf.data_ptr(),
                      qf.data_ptr(), *scratch, 1, 4, 1, 1, 1000, 64, 0,
                      0.125, nsplit, split, ftile, 0, None, device=card)
    torch.cuda.synchronize()
    assert tops.KERNELS["flash_decode"].launches == before + 2


@pytest.mark.gpu
def test_decode_split_is_the_launchers_rule(card):
    # decode_split keeps the launcher's flash_decode_per for the plain
    # version, which runs where no card is: the two give the same keys
    for dtype in (torch.bfloat16, torch.float32):
        for B, Hkv, Skv, d in ((32, 8, 4096, 64), (1, 1, 1, 64),
                               (2, 2, 1000, 64), (1, 8, 100_000, 128),
                               (1, 16, 1024, 128), (1, 32, 1024, 112),
                               (4, 16, 1024, 64), (1, 1, 4097, 64),
                               (1, 1, 129, 32), (3, 5, 31, 80)):
            assert tfa.decode_split(B, Hkv, Skv, dtype, d)[1] == \
                tfa.decode_per(B, Hkv, Skv, dtype, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Skv,d", [(130, 64), (4097, 64), (31, 112)])
def test_decode_ragged_tile_reads_no_other_groups_rows(card, Skv, d, dtype):
    # group 0's last tile is partial: its copy stops at key Skv - 1 and the
    # stage's other rows are never read, so group 1's inf K and V rows,
    # which follow in memory, leave group 0's output finite
    B, H, Hkv = 2, 4, 1
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, 1, Skv, d), dtype, card)
    k[1] = float("inf")
    v[1] = float("inf")
    kw = dict(causal=False, q_blk=1, kv_blk=Skv)
    got = _launch_once("flash_decode",
                       lambda: tops.flash_attention(q, k, v, **kw))[:1]
    assert torch.isfinite(got).all()
    _close_to_plain(got, tfa.flash_decode_plain(q, k, v, **kw)[:1], "decode")


def _off_16_bytes(t):
    """``t`` copied into a view one element past a 16-byte boundary."""
    base = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    return base[1:1 + t.numel()].view(t.shape).copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,offset", (("float32", False),
                                          ("float32", True),
                                          ("bfloat16", True)))
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", PREFILL + SIMT_RAGGED)
def test_simt_prefill_matches_its_plain_version_and_the_oracle(
        card, B, H, Hkv, Sq, Skv, d, causal, dtype, offset):
    # float32 on 16-byte boundaries stages K and V by cp.async; a q one
    # element off (the bfloat16 calls the tensor-core route refuses, and
    # float32 views) stages them through registers
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), dtype, card)
    if offset:
        q = _off_16_bytes(q)
    assert tfa.route(q, k, v) == "simt"
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    got = _launch_once("flash_attention",
                       lambda: tops.flash_attention(q, k, v, **kw))
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == q.dtype and torch.isfinite(got).all()
    _close_to_plain(got, want, "simt")
    _close(got, tref.flash_attention_ref(q, k, v, causal=causal).float()
           .cpu().numpy(), TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("d,want", ((1, 128), (16, 128), (32, 128),
                                    (33, 256), (48, 256), (64, 256),
                                    (65, 64), (128, 64)))
def test_simt_ctas_own_the_query_tile(card, d, want):
    # the launcher's own counts: 256 queries a CTA at 33 <= d <= 64, 128
    # below, 64 above
    assert tfa.simt_q_tile(d) == want
    assert tfa.simt_ctas(2, 4, 300, d) == 2 * 4 * -(-300 // want)
    assert tfa.simt_ctas(2, 32, 4096, 64) == 2 * 32 * 16


@pytest.mark.gpu
@pytest.mark.parametrize("d,want", ((8, 192), (32, 192), (64, 192),
                                    (72, 128), (112, 128), (128, 128)))
def test_tc_ctas_own_the_query_tile(card, d, want):
    # the launcher's choice: three consumer warpgroups of 64 rows at
    # d <= 64, two above
    assert tfa.tc_q_tile(d) == want
