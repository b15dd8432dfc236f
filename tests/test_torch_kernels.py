"""The port's hot-path kernels (matmul, rmsnorm, flash attention) against
the JAX package's Pallas kernels.

On the CPU each case runs the reference's ``ops.<fn>(mode="interpret")``
(the Pallas interpret path, as ``tests/test_kernels.py`` runs it) and the
port's ``ops.<fn>`` on CPU tensors (the kernels' plain versions), on the
same NumPy inputs from one seed, at ``tests/test_kernels.py``'s shapes and
tolerances.  bfloat16 inputs are made in float32 and cast on each side
(both round to nearest even), never carried through NumPy.

The tests marked ``gpu`` hold each kernel against its plain version on the
card at the same shapes, in both dtypes, and count its launches; they skip
elsewhere and run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_kernels.py``.  JAX is imported by the CPU tests alone,
since the machine with the card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import cuda_suite  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402

DTYPES = ("float32", "bfloat16")
#: tests/test_kernels.py's sweeps
FLASH = [(1, 4, 4, 128, 128, 64, True),      # MHA causal
         (2, 8, 2, 256, 256, 64, True),      # GQA 4:1
         (1, 4, 1, 64, 256, 128, False),     # MQA cross
         (2, 2, 2, 1, 128, 64, False),       # decode-shaped
         (1, 6, 3, 96, 96, 32, True)]        # non-128-aligned
RMSNORM = [(64, 256, 8), (33, 128, 8), (8, 512, 1)]
#: rows at the CUDA kernel's widths: granite-3-2b's d_model 2048 (16 and
#: 8 chunks of 16 bytes a lane in float32 and bfloat16), minicpm-2b's 2304
#: (the widest float32 row its switch holds in registers), a ragged last
#: chunk, and a row past the switch (two passes)
RMSNORM_WIDE = [(16, 2048, 8), (4, 2304, 2), (5, 2056, 8), (3, 8192, 1)]
#: elements in one 16-byte chunk of x, by dtype
VEC = {"float32": 4, "bfloat16": 8}
MATMUL = [(128, 128, 128, 1), (256, 128, 64, 2), (64, 256, 128, 1)]
#: (M, N, K, bm, bn, bk) off the CUDA-core kernel's 128 x 128 tiles and
#: 16-deep slices: M, N, K of whole groups of four (its 16-byte
#: instantiation in float32), then N % 4 and K % 4, and K % 4 alone, != 0
#: (the instantiation of one element an access)
MATMUL_EDGES = [(72, 200, 40, 8, 8, 8), (72, 198, 42, 8, 18, 6),
                (130, 36, 30, 10, 36, 10)]
TOL = {"flash": {"float32": 2e-5, "bfloat16": 2e-2},
       "rmsnorm": {"float32": 1e-5, "bfloat16": 2e-2},
       "matmul": {"float32": 5e-5, "bfloat16": 5e-2}}


def _jax():
    """The reference's jnp and kernels (imported here, not at the top)."""
    import jax.numpy as jnp

    from repro.kernels import ops, ref
    return jnp, ops, ref


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _to_jax(arrays, dtype):
    jnp = _jax()[0]
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _to_torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device).to(getattr(torch, dtype))
            for a in arrays]


def _close(got, want, tol):
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_to_plain(got, want, which):
    """``got`` from the kernel of route ``which`` within its plain
    version's ``want`` at ``flash_attention.PLAIN_TOL``."""
    rtol, atol = tfa.PLAIN_TOL[which, want.dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def _flash_inputs(B, H, Hkv, Sq, Skv, d):
    return _draw(7, (B, H, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", FLASH)
def test_flash_attention_matches_the_reference(B, H, Hkv, Sq, Skv, d,
                                               causal, dtype):
    arrays = _flash_inputs(B, H, Hkv, Sq, Skv, d)
    jops = _jax()[1]
    want = jops.flash_attention(*_to_jax(arrays, dtype), causal=causal,
                                mode="interpret", q_blk=32, kv_blk=32)
    got = tops.flash_attention(*_to_torch(arrays, dtype), causal=causal,
                               q_blk=32, kv_blk=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, TOL["flash"][dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,D,grain", RMSNORM + RMSNORM_WIDE)
def test_rmsnorm_matches_the_reference(rows, D, grain, dtype):
    x, s = _draw(8, (rows, D), (D,))
    jnp, jops, _ = _jax()
    want = jops.rmsnorm(_to_jax([x], dtype)[0], jnp.asarray(s),
                        mode="interpret", grain=grain)
    got = tops.rmsnorm(_to_torch([x], dtype)[0], torch.from_numpy(s),
                       grain=grain)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, TOL["rmsnorm"][dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,N,K,grain", MATMUL)
def test_matmul_matches_the_reference(M, N, K, grain, dtype):
    arrays = _draw(9, (M, K), (K, N))
    jops = _jax()[1]
    want = jops.matmul(*_to_jax(arrays, dtype), mode="interpret", bm=64,
                       bn=64, bk=64, grain=grain)
    got = tops.matmul(*_to_torch(arrays, dtype), bm=64, bn=64, bk=64,
                      grain=grain)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, TOL["matmul"][dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,N,K,bm,bn,bk", MATMUL_EDGES)
def test_matmul_matches_the_reference_off_the_kernels_tiles(M, N, K, bm, bn,
                                                            bk, dtype):
    # shapes the reference's blocks take whole, which the CUDA-core
    # kernel covers with ragged tiles, slices and groups of four
    arrays = _draw(9, (M, K), (K, N))
    jops = _jax()[1]
    kw = dict(bm=bm, bn=bn, bk=bk)
    want = jops.matmul(*_to_jax(arrays, dtype), mode="interpret", **kw)
    got = tops.matmul(*_to_torch(arrays, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, TOL["matmul"][dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_oracles_match_the_reference_oracles(dtype):
    jnp, _, jref = _jax()
    arrays = _flash_inputs(2, 8, 2, 96, 128, 32)
    for causal in (True, False):
        _close(tref.flash_attention_ref(*_to_torch(arrays, dtype),
                                        causal=causal),
               jref.flash_attention_ref(*_to_jax(arrays, dtype),
                                        causal=causal),
               TOL["flash"][dtype])
    x, s = _draw(8, (33, 128), (128,))
    _close(tref.rmsnorm_ref(_to_torch([x], dtype)[0], torch.from_numpy(s)),
           jref.rmsnorm_ref(_to_jax([x], dtype)[0], jnp.asarray(s)),
           TOL["rmsnorm"][dtype])
    arrays = _draw(9, (64, 96), (96, 80))
    _close(tref.matmul_ref(*_to_torch(arrays, dtype)),
           jref.matmul_ref(*_to_jax(arrays, dtype)), TOL["matmul"][dtype])


def test_ref_mode_runs_the_oracle():
    arrays = _flash_inputs(1, 4, 2, 64, 64, 32)
    q, k, v = _to_torch(arrays, "float32")
    assert torch.equal(tops.flash_attention(q, k, v, mode="ref"),
                       tref.flash_attention_ref(q, k, v))
    x, s = _to_torch(_draw(8, (8, 64), (64,)), "float32")
    assert torch.equal(tops.rmsnorm(x, s, mode="ref"),
                       tref.rmsnorm_ref(x, s))
    a, b = _to_torch(_draw(9, (32, 16), (16, 8)), "float32")
    assert torch.equal(tops.matmul(a, b, mode="ref"), tref.matmul_ref(a, b))


def test_flash_matches_the_models_flash():
    """The port's kernel and the reference model's XLA flash path agree,
    at tests/test_kernels.py's shape."""
    jnp = _jax()[0]
    from repro.models.attention import flash_attention as model_flash
    B, S, Hkv, g, hd = 1, 128, 2, 2, 64
    q, k, v = _draw(10, (B, S, Hkv, g, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))
    want = model_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, q_chunk=32, kv_chunk=32)
    qh = torch.from_numpy(q).reshape(B, S, Hkv * g, hd).movedim(1, 2)
    got = tops.flash_attention(qh.contiguous(),
                               torch.from_numpy(k).movedim(1, 2).contiguous(),
                               torch.from_numpy(v).movedim(1, 2).contiguous(),
                               causal=True, q_blk=32, kv_blk=32)
    got = got.movedim(2, 1).reshape(B, S, Hkv, g, hd)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("causal", (True, False))
def test_plain_flash_walks_the_kernels_tiles_with_a_top_left_mask(causal):
    # Sq != Skv: the mask is qpos >= kpos from 0 (not FA2's bottom-right),
    # over three or four of the kernel's kv tiles, the last one ragged
    arrays = _flash_inputs(1, 2, 1, 150, 200, 16)
    q, k, v = _to_torch(arrays, "float32")
    got = tfa.flash_attention_plain(q, k, v, causal=causal, q_blk=150,
                                    kv_blk=200)
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    if causal:      # row 0 sees key 0 alone
        torch.testing.assert_close(got[0, :, 0], v[0, :, 0].expand(2, 16))


@pytest.mark.parametrize("fn,args,kw", [
    ("flash_attention", ((1, 2, 96, 32), (1, 2, 96, 32), (1, 2, 96, 32)),
     {"q_blk": 64}),
    ("flash_attention", ((1, 2, 64, 32), (1, 2, 96, 32), (1, 2, 96, 32)),
     {"kv_blk": 64}),
    ("matmul", ((64, 32), (48, 64)), {}),
    ("matmul", ((96, 64), (64, 64)), {"bm": 64}),
    ("matmul", ((64, 64), (64, 96)), {"bn": 64}),
    ("matmul", ((64, 96), (96, 64)), {"bk": 64}),
    ("matmul", ((96, 64), (64, 64)), {"bm": 32, "grain": 2})])
def test_refuses_the_shapes_the_reference_asserts_on(fn, args, kw):
    arrays = _draw(11, *args)
    jops = _jax()[1]
    with pytest.raises(AssertionError):
        getattr(jops, fn)(*_to_jax(arrays, "float32"), mode="interpret",
                          **kw)
    tensors = _to_torch(arrays, "float32")
    with pytest.raises(ValueError, match="whole|K"):
        getattr(tops, fn)(*tensors, **kw)
    plain = {"flash_attention": tfa.flash_attention_plain,
             "matmul": tmm.matmul_plain}[fn]
    with pytest.raises(ValueError, match="whole|K"):
        plain(*tensors, **kw)


def test_modes():
    x, s = _to_torch(_draw(8, (8, 64), (64,)), "float32")
    assert tops.default_mode(x) == "interpret"
    with pytest.raises(ValueError, match="mode 'cuda'"):
        tops.rmsnorm(x, s, mode="cuda")
    with pytest.raises(ValueError, match="mode 'cuda'"):
        tops.matmul(x, x.t().contiguous(), mode="cuda")
    with pytest.raises(ValueError, match="mode 'cuda'"):
        tops.flash_attention(x[None, None], x[None, None], x[None, None],
                             mode="cuda")
    with pytest.raises(ValueError, match="not one of"):
        tops.rmsnorm(x, s, mode="pallas")
    # CPU tensors run the plain version, which is no launch
    before = {n: k.launches for n, k in tops.KERNELS.items()}
    assert torch.equal(tops.rmsnorm(x, s), trn.rmsnorm_plain(x, s))
    assert torch.equal(trn.rmsnorm(x, s), trn.rmsnorm_plain(x, s))
    assert {n: k.launches for n, k in tops.KERNELS.items()} == before


def test_wrappers_refuse_what_their_kernels_do_not_take():
    x, s = _to_torch(_draw(8, (8, 64), (64,)), "float32")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trn.rmsnorm(x.double(), s)
    with pytest.raises(ValueError, match="contiguous"):
        trn.rmsnorm(x.t(), s[:8])
    with pytest.raises(ValueError, match="scale"):
        trn.rmsnorm(x, s[:32])
    with pytest.raises(TypeError, match="b is"):
        tmm.matmul(x, x.t().contiguous().to(torch.bfloat16))
    q = x.reshape(1, 2, 4, 64)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tfa.flash_attention(q, q[:, :1].expand(1, 3, 4, 64).contiguous(),
                            q[:, :1].expand(1, 3, 4, 64).contiguous())


def test_rmsnorm_takes_a_scale_of_another_dtype():
    # the reference's tests pass float32 scale with bfloat16 x; a bfloat16
    # scale is widened the same way
    x, s = _draw(8, (33, 128), (128,))
    jnp, jops, _ = _jax()
    xb = _to_torch([x], "bfloat16")[0]
    for scale_dtype in DTYPES:
        want = jops.rmsnorm(_to_jax([x], "bfloat16")[0],
                            _to_jax([s], scale_dtype)[0], mode="interpret")
        got = tops.rmsnorm(xb, _to_torch([s], scale_dtype)[0])
        assert got.dtype == torch.bfloat16
        _close(got, want, TOL["rmsnorm"]["bfloat16"])


def test_carry_takes_a_bfloat16_array_bit_for_bit():
    jnp = _jax()[0]
    x = _draw(12, (5, 7))[0]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    t = carry.from_reference({"x": xb, "y": x}, device="cpu")
    assert t["x"].dtype == torch.bfloat16 and t["x"].shape == (5, 7)
    np.testing.assert_array_equal(t["x"].view(torch.int16).numpy(),
                                  np.asarray(xb).view(np.int16))
    assert torch.equal(t["x"], torch.from_numpy(x).to(torch.bfloat16))
    assert t["y"].dtype == torch.float32


# ---- on the card ------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launch_once(name, call):
    """``call()`` through ops with mode=None; its kernel (``tops.KERNELS``
    name) launched once, and no other."""
    before = {n: k.launches for n, k in tops.KERNELS.items()}
    out = call()
    torch.cuda.synchronize()
    before[name] += 1
    assert {n: k.launches for n, k in tops.KERNELS.items()} == before
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", FLASH)
def test_flash_attention_kernel_matches_its_plain_version(
        card, B, H, Hkv, Sq, Skv, d, causal, dtype):
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), dtype, card)
    name = tops.ROUTES["flash_attention"][tfa.route(q, k, v)]
    got = _launch_once(name, lambda: tops.flash_attention(
        q, k, v, causal=causal, q_blk=32, kv_blk=32))
    want = tfa.plain(q, k, v, causal=causal, q_blk=32, kv_blk=32)
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    _close_to_plain(got, want, tfa.route(q, k, v))


def _offset_copy(t):
    """``t`` copied into a view one element past a 16-byte boundary."""
    base = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    return base[1:1 + t.numel()].view(t.shape).copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,d,causal", FLASH + [
    (1, 4, 1, 80, 70, 20, True), (1, 4, 1, 80, 70, 20, False)])
def test_flash_attention_simt_kernel_takes_bfloat16(card, B, H, Hkv, Sq,
                                                    Skv, d, causal):
    # bfloat16 calls that cp.async cannot copy run csrc/flash_attention.cu:
    # FLASH's shapes with q 2 bytes past a 16-byte boundary, and d % 8 != 0
    q, k, v = _to_torch(_flash_inputs(B, H, Hkv, Sq, Skv, d), "bfloat16",
                        card)
    if d % 8 == 0:
        q = _offset_copy(q)
    assert tfa.route(q, k, v) == "simt"
    got = _launch_once("flash_attention", lambda: tops.flash_attention(
        q, k, v, causal=causal, q_blk=Sq, kv_blk=Skv))
    want = tfa.flash_attention_plain(q, k, v, causal=causal, q_blk=Sq,
                                     kv_blk=Skv)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    _close_to_plain(got, want, "simt")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,D,grain", RMSNORM + [(40, 100, 8)])
def test_rmsnorm_kernel_matches_its_plain_version(card, rows, D, grain,
                                                  dtype):
    x, s = _draw(8, (rows, D), (D,))
    x = _to_torch([x], dtype, card)[0]
    for scale in _to_torch([s], "float32", card) + _to_torch([s], dtype,
                                                              card):
        got = _launch_once("rmsnorm",
                           lambda: tops.rmsnorm(x, scale, grain=grain))
        want = trn.rmsnorm_plain(x, scale, grain=grain)
        assert got.dtype == x.dtype
        _close(got, want.float().cpu().numpy(), TOL["rmsnorm"][dtype])


def _rmsnorm_on_the_card(card, rows, d, grain, dtype, off=""):
    """One launch a call of each scale dtype over x[rows, d], the tensor
    named ``off`` (x or scale) one element past a 16-byte boundary; held
    to the plain version and the oracle at ``TOL``."""
    x, s = _draw(8, (rows, d), (d,))
    x = _to_torch([x], dtype, card)[0]
    if off == "x":
        x = _offset_copy(x)
        assert x.data_ptr() % 16
    tol = TOL["rmsnorm"][dtype]
    for scale in _to_torch([s], "float32", card) + _to_torch([s], "bfloat16",
                                                              card):
        if off == "scale":
            scale = _offset_copy(scale)
            assert scale.data_ptr() % 16
        got = _launch_once("rmsnorm",
                           lambda: tops.rmsnorm(x, scale, grain=grain))
        assert got.dtype == x.dtype and got.shape == x.shape
        for want in (trn.rmsnorm_plain(x, scale, grain=grain),
                     tref.rmsnorm_ref(x, scale)):
            _close(got, want.float().cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", range(1, 19))
def test_rmsnorm_kernel_at_every_chunk_count(card, k, dtype):
    # d = 32 VEC k: each width the launcher's switch holds in registers,
    # over 33 rows, so that the last of five CTAs has one live warp
    _rmsnorm_on_the_card(card, 33, 32 * VEC[dtype] * k, 8, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,grain,off", [
    (5, 2056, 8, ""),       # a ragged last chunk
    (4, 4104, 2, ""),       # a ragged 17th chunk in bfloat16
    (3, 8192, 1, ""),       # past the switch: two passes, 16-byte loads
    (40, 100, 8, ""),       # d % 8 != 0: bfloat16 one element a load
    (40, 102, 3, ""),       # d % 4 != 0 as well
    (33, 2048, 8, "x"),     # x off a 16-byte boundary: one element a load
    (33, 2048, 8, "scale"),  # scale off one: two passes, 16-byte loads
    (1, 2048, 1, ""), (7, 2048, 3, ""), (33, 2048, 3, ""),
    (8192, 2048, 8, "")])   # the main path's shape
def test_rmsnorm_kernel_off_its_chunks(card, rows, d, grain, off, dtype):
    _rmsnorm_on_the_card(card, rows, d, grain, dtype, off)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,want", [
    (8192, 1024), (1, 1), (7, 1), (8, 1), (33, 5), (8200, 1025)])
def test_rmsnorm_ctas_are_a_warp_a_row(card, rows, want):
    # the launcher's own count of the CTAs of 8 warps it starts, the same
    # for every width, dtype and grain
    assert trn.ctas(rows) == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,N,K,grain", MATMUL + [(72, 200, 40, 1)])
def test_matmul_kernel_matches_its_plain_version(card, M, N, K, grain,
                                                 dtype):
    a, b = _to_torch(_draw(9, (M, K), (K, N)), dtype, card)
    blk = 8 if M == 72 else 64
    name = tops.ROUTES["matmul"][tmm.route(a, b)]
    got = _launch_once(name, lambda: tops.matmul(a, b, bm=blk, bn=blk,
                                                 bk=blk, grain=grain))
    want = tmm.matmul_plain(a, b, bm=blk, bn=blk, bk=blk, grain=grain)
    assert got.dtype == a.dtype
    _close(got, want.float().cpu().numpy(), TOL["matmul"][dtype])


def _matmul_tol(dtype, K):
    """``TOL``'s, the float32 one grown with depth as ``matmul_tol``
    (4.5e-4 at K = 2048, ``chip_smoke.hot_tol``'s)."""
    if dtype == "bfloat16":
        return TOL["matmul"][dtype]
    return max(TOL["matmul"][dtype], cuda_suite.matmul_tol(K))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,N,K,bm,bn,bk,offset", [
    *(edge + (0,) for edge in MATMUL_EDGES),
    (72, 200, 40, 8, 8, 8, 1), (130, 36, 30, 10, 36, 10, 1),
    (8192, 8192, 2048, 128, 128, 128, 0)])
def test_simt_matmul_off_its_tiles_and_groups_of_four(card, M, N, K, bm, bn,
                                                     bk, offset, dtype):
    # the CUDA-core kernel's 16-byte instantiation (float32, whole groups
    # of four, aligned) and its instantiation of one element an access
    # (bfloat16, N % 4 or K % 4 != 0, views one element off a 16-byte
    # boundary), at ragged tiles and slices and at the main path's shape;
    # bfloat16 that TMA could take is moved off its boundary
    a, b = _to_torch(_draw(9, (M, K), (K, N)), dtype, card)
    if offset or tmm.route(a, b) != "simt":
        a, b = _offset_copy(a), _offset_copy(b)
    assert tmm.route(a, b) == "simt"
    if offset:
        assert a.data_ptr() % 16 and b.data_ptr() % 16
    kw = dict(bm=bm, bn=bn, bk=bk)
    got = _launch_once("matmul", lambda: tops.matmul(a, b, **kw))
    assert got.dtype == a.dtype and got.shape == (M, N)
    assert torch.isfinite(got).all()
    tol = _matmul_tol(dtype, K)
    _close(got, tmm.matmul_plain(a, b, **kw).float().cpu().numpy(), tol)
    _close(got, tref.matmul_ref(a, b).float().cpu().numpy(), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,want", [
    (8192, 8192, 4096),       # granite's MLP: 64 x 64 tiles, 31.03 waves
    (72, 200, 2), (128, 128, 1), (129, 1, 2), (1, 257, 3)])
def test_simt_matmul_ctas_cover_c_in_128_by_128_tiles(card, M, N, want):
    # the launcher's own count of the CTAs it starts
    assert tmm.simt_ctas(M, N) == want


@pytest.mark.gpu
@pytest.mark.parametrize("d", (32, 64, 80, 128))
def test_flash_attention_kernel_on_every_head_width(card, d):
    # d = 128 takes 91 KB of shared memory, past the 48 KB a launch gets
    # without the opt-in; d = 80 runs padded to 128; a causal Sq > Skv and
    # a ragged Skv on top
    q, k, v = _to_torch(_flash_inputs(1, 4, 1, 80, 70, d), "float32", card)
    assert tfa.route(q, k, v) == "simt"
    for causal in (True, False):
        got = _launch_once("flash_attention", lambda: tops.flash_attention(
            q, k, v, causal=causal, q_blk=16, kv_blk=70))
        want = tref.flash_attention_ref(q, k, v, causal=causal)
        _close(got, want.cpu().numpy(), 2e-5)


@pytest.mark.gpu
def test_cuda_mode_never_falls_back(card):
    x = torch.ones(4, 8, dtype=torch.float64, device=card)
    with pytest.raises(TypeError):
        tops.rmsnorm(x, x[0], mode="cuda")
    q = torch.ones(1, 1, 4, 160, device=card)
    with pytest.raises(ValueError, match="exceeds"):
        tops.flash_attention(q, q, q)
    assert tops.default_mode(q) == "cuda"
    # each route's launcher refuses what its kernel does not take, rather
    # than compute it another way: TMA's N % 8, cp.async's d % 8, the
    # decode kernel's rows of a kv group
    bf = torch.ones(16, 16, dtype=torch.bfloat16, device=card)
    with pytest.raises(RuntimeError, match="launch_matmul_tc"):
        tmm.KERNEL_TC(bf.data_ptr(), bf.data_ptr(), bf.data_ptr(), 16, 12,
                      16, device=card)
    qb = torch.ones(1, 1, 8, 12, dtype=torch.bfloat16, device=card)
    with pytest.raises(RuntimeError, match="launch_flash_attention_tc"):
        tfa.KERNEL_TC(*(qb.data_ptr(),) * 4, 1, 1, 1, 8, 8, 12, 1, 0.3,
                      device=card)
    with pytest.raises(RuntimeError, match="launch_flash_decode"):
        tfa.KERNEL_DECODE(*(qb.data_ptr(),) * 7, 1, 16, 1, 1, 8, 8, 0, 0.3,
                          32, 1, 32, 1, device=card)
    # nor a key tile other than its own, which the plain version walks
    assert tfa.decode_tile(torch.bfloat16, 8) == 32
    with pytest.raises(RuntimeError, match="launch_flash_decode"):
        tfa.KERNEL_DECODE(*(qb.data_ptr(),) * 7, 1, 8, 1, 1, 8, 8, 0, 0.3,
                          32, 1, 16, 1, device=card)
    # and each route's call launches its kernel, never the plain version
    a = torch.ones(64, 64, dtype=torch.bfloat16, device=card)
    for fn, call, name in (
            ("matmul", lambda: tops.matmul(a, a, mode="cuda"), "matmul_tc"),
            ("matmul", lambda: tops.matmul(a.float(), a.float(),
                                           mode="cuda"), "matmul"),
            ("flash_attention", lambda: tops.flash_attention(
                a[None, None], a[None, None], a[None, None], mode="cuda"),
             "flash_attention_tc"),
            ("flash_attention", lambda: tops.flash_attention(
                a[None, None, :1], a[None, None], a[None, None],
                mode="cuda"), "flash_decode")):
        _launch_once(name, call)
