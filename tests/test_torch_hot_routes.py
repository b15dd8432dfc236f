"""The routes of the hot-path matmul and flash attention, and the plain
versions of their newer kernels, against the JAX package.

``matmul.route`` and ``flash_attention.route`` pick a kernel from dtypes,
shapes and alignment alone; the tests here pin that table.  On the CPU,
``flash_decode_plain`` (the split-kv decode kernel's arithmetic) is held
against the reference's ``ops.flash_attention(mode="interpret")`` at
``tests/test_kernels.py``'s tolerances (2e-5 float32, 2e-2 bfloat16), and
``flash_attention_plain``'s bfloat16 rounding of p (the tensor-core
kernel's) against the same reference.

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
#: the "simt" kernel's ragged cases: Sq and Skv off its query tile (256
#: at d = 48 and 64, 128 at d = 16, 64 at d = 128) and off the 64-key
#: tile, head widths 16, 48 and 128, causal and not, GQA
SIMT_RAGGED = [(1, 4, 1, 300, 300, 64, True), (1, 4, 2, 130, 77, 64, False),
               (1, 2, 2, 129, 260, 16, True), (1, 4, 2, 100, 333, 48, True),
               (1, 2, 1, 70, 150, 128, True), (2, 2, 1, 65, 65, 128, False)]
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


def test_decode_split_covers_the_cache_in_whole_32s():
    for B, Hkv, Skv in ((32, 8, 4096), (1, 1, 1), (2, 2, 1000),
                        (1, 8, 100_000)):
        split, nsplit = tfa.decode_split(B, Hkv, Skv)
        assert split % 32 == 0 and nsplit == -(-Skv // split)
        assert B * Hkv * nsplit <= tfa.DECODE_WARPS + B * Hkv
    # granite-3-2b's decode: 256 kv groups, 8 splits of 512 keys each
    assert tfa.decode_split(32, 8, 4096) == (512, 8)
    assert [tfa.decode_tile(torch.bfloat16, d) for d in (32, 64, 80, 128)] \
        == [32, 16, 8, 8]
    assert [tfa.decode_tile(torch.float32, d) for d in (32, 64, 128)] \
        == [16, 8, 4]


def test_ops_routes_name_launchers():
    for fn, routes in tops.ROUTES.items():
        for name in routes.values():
            assert name in tops.KERNELS
    assert set(tops.KERNELS) == {"rmsnorm", *(n for r in tops.ROUTES.values()
                                              for n in r.values())}


# ---- plain versions against the reference -------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", DECODE)
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
    assert tfa.decode_split(1, 1, 200)[1] == 7
    got = tfa.flash_decode_plain(q, k, v, causal=True, q_blk=2, kv_blk=200)
    torch.testing.assert_close(got[0, :, 0], v[0, :, 0].expand(4, 32))
    torch.testing.assert_close(got, tref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", FLASH)
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
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", PREFILL + [
    (1, 4, 1, 100, 300, 64, True),     # Sq < Skv: top-left, not bottom-right
    (1, 4, 1, 300, 100, 64, True),     # Sq > Skv
    (2, 4, 2, 128, 128, 32, True), (2, 4, 2, 128, 128, 64, False),
    (1, 4, 1, 80, 70, 80, True), (1, 4, 1, 80, 70, 128, True)])
def test_tc_prefill_matches_its_plain_version(card, B, H, Hkv, Sq, Skv, d,
                                              causal):
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), "bfloat16",
                        card)
    assert tfa.route(q, k, v) == "tc"
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    got = _launch_once("flash_attention_tc",
                       lambda: tops.flash_attention(q, k, v, **kw))
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    _close_to_plain(got, want, "tc")
    _close(got, tref.flash_attention_ref(q, k, v, causal=causal).float()
           .cpu().numpy(), TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", DECODE + [
    (2, 2, 2, 1, 128, 64, False), (32, 32, 8, 1, 4096, 64, False),
    (1, 8, 1, 1, 500, 80, True), (2, 8, 2, 2, 128, 32, True)])
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
