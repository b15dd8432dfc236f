"""The training path's loss pieces against the reference's, on the CPU:
``cross_entropy``, the chunked flash forward with its logsumexp, the
trainable flash's gradients, RMSNorm's gradient, and each flash route's
``lse`` output (the plain versions the kernels are held to on the card).

The reference runs as its own tests run it on the CPU (jnp, jitted where
its tests jit).  Tolerances: ``cross_entropy`` 1e-6; the trainable flash
rtol 1e-4 / atol 1e-5, the reference's own
``test_flash_vjp_matches_autodiff``; ``torch.autograd.gradcheck`` in
float64 for the two autograd Functions.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402

CE_TOL = 1e-6
#: the reference's test_flash_vjp_matches_autodiff
VJP_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.models import attention, common
    return jax, jnp, attention, common


# ---- cross_entropy --------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("vpad", [0, 5])
def test_cross_entropy_matches_the_reference(masked, vpad):
    _, jnp, _, common = _jax()
    rng = np.random.default_rng(vpad + 10 * masked)
    V = 37
    logits = rng.standard_normal((3, 7, V + vpad)).astype(np.float32) * 3
    logits[..., V:] = rng.standard_normal((3, 7, vpad)) * 10  # garbage pad
    targets = rng.integers(0, V, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(common.cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets),
        mask=None if mask is None else jnp.asarray(mask),
        real_vocab=V if vpad else None))
    got = tcommon.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        mask=None if mask is None else torch.from_numpy(mask),
        real_vocab=V if vpad else None)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=CE_TOL, atol=CE_TOL)


def test_cross_entropy_takes_bfloat16_logits_and_an_empty_mask():
    _, jnp, _, common = _jax()
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 16)).astype(np.float32)
    targets = rng.integers(0, 12, (2, 5)).astype(np.int32)
    want = float(common.cross_entropy(jnp.asarray(logits).astype("bfloat16"),
                                      jnp.asarray(targets), real_vocab=12))
    got = tcommon.cross_entropy(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(targets), real_vocab=12)
    np.testing.assert_allclose(float(got), want, rtol=CE_TOL, atol=CE_TOL)
    zero = np.zeros((2, 5), np.float32)     # the mean over max(sum, 1)
    want0 = float(common.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(targets),
                                       mask=jnp.asarray(zero)))
    got0 = tcommon.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 mask=torch.from_numpy(zero))
    assert float(got0) == want0 == 0.0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("vpad", [0, 3, 17])
def test_cross_entropy_vs_naive(seed, vpad):
    """tests/test_property.py::test_cross_entropy_vs_naive's counterpart."""
    rng = np.random.default_rng(seed)
    V = 11
    logits = rng.standard_normal((3, 5, V + vpad)).astype(np.float32)
    logits[..., V:] = rng.standard_normal((3, 5, vpad)) * 10  # garbage pad
    targets = rng.integers(0, V, (3, 5)).astype(np.int32)
    ours = float(tcommon.cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(targets),
                                       real_vocab=V))
    p = logits[..., :V]
    p = p - p.max(-1, keepdims=True)
    logp = p - np.log(np.exp(p).sum(-1, keepdims=True))
    want = -np.take_along_axis(logp, targets[..., None], -1).mean()
    np.testing.assert_allclose(ours, want, rtol=1e-4, atol=1e-5)


# ---- the chunked flash forward ------------------------------------------
def _qkv(B, S, Hkv, g, hd, seed, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Skv or S
    return (rng.standard_normal((B, S, Hkv, g, hd)).astype("f"),
            rng.standard_normal((B, Skv, Hkv, hd)).astype("f"),
            rng.standard_normal((B, Skv, Hkv, hd)).astype("f"))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(8, 8), (16, 8), (8, 32), (5, 7)])
def test_flash_fwd_lse_matches_the_reference(chunks, causal):
    _, jnp, attention, _ = _jax()
    q, k, v = _qkv(2, 32, 2, 2, 16, 1)
    want_o, want_l = attention._flash_fwd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=chunks[0], kv_chunk=chunks[1])
    got_o, got_l = tattn._flash_fwd_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_chunk=chunks[0], kv_chunk=chunks[1])
    assert got_o.shape == want_o.shape and got_l.shape == want_l.shape
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **VJP_TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **VJP_TOL)


@pytest.mark.parametrize("q_offset,kv_len", [(0, None), (7, None), (0, 19),
                                             (4, 25)])
def test_chunked_flash_attention_matches_the_reference(q_offset, kv_len):
    _, jnp, attention, _ = _jax()
    q, k, v = _qkv(2, 8, 2, 3, 16, 2, Skv=32)
    kw = dict(causal=True, q_chunk=4, kv_chunk=8, q_offset=q_offset,
              kv_len=kv_len)
    want = attention.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VJP_TOL)


def test_chunked_flash_attention_keeps_a_bfloat16_input_dtype():
    _, jnp, attention, _ = _jax()
    q, k, v = _qkv(1, 16, 2, 2, 16, 3)
    args = [jnp.asarray(x).astype("bfloat16") for x in (q, k, v)]
    want = attention.flash_attention(*args, causal=True, q_chunk=8,
                                     kv_chunk=8)
    got = tattn.flash_attention(*(torch.from_numpy(x).bfloat16()
                                  for x in (q, k, v)), causal=True,
                                q_chunk=8, kv_chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


# ---- the trainable flash ----------------------------------------------------
#: (B, S, Hkv, g, hd, q_chunk, kv_chunk): the reference test's shape at
#: chunks of 8; its causal prompt of 4 rows a kv group, which
#: ``flash_attention.route`` sends to the decode kernel; GQA of 3 at
#: ragged chunks (whole-sequence tiles)
TRAIN_SHAPES = {"ref-test": (2, 32, 2, 2, 16, 8, 8),
                "decode-route": (2, 4, 2, 1, 16, 2, 2),
                "gqa3-ragged": (1, 24, 2, 3, 16, 7, 10)}


@pytest.mark.parametrize("name", list(TRAIN_SHAPES))
def test_flash_trainable_grads_match_the_reference_vjp(name):
    jax, jnp, attention, _ = _jax()
    B, S, Hkv, g, hd, qc, kc = TRAIN_SHAPES[name]
    q, k, v = _qkv(B, S, Hkv, g, hd, 5)
    kw = dict(causal=True, q_chunk=qc, kv_chunk=kc)

    def ours(q, k, v):
        o = attention.flash_attention_trainable(q, k, v, **kw)
        return jnp.sum(jnp.tanh(o))

    want = jax.grad(ours, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    if name == "decode-route":
        qh = tq.detach().reshape(B, S, Hkv * g, hd).transpose(1, 2)
        assert tfa.route(qh.contiguous(), tk.detach().transpose(1, 2)
                         .contiguous(), tv.detach().transpose(1, 2)
                         .contiguous()) == "decode"
    out = tattn.flash_attention_trainable(tq, tk, tv, **kw)
    torch.tanh(out).sum().backward()
    for a, b in zip(want, (tq.grad, tk.grad, tv.grad), strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **VJP_TOL)


def test_flash_trainable_takes_bfloat16():
    """A bfloat16 call (the "tc" plain version's forward) gives grads in
    bfloat16 that follow the reference's custom VJP."""
    jax, jnp, attention, _ = _jax()
    q, k, v = _qkv(1, 16, 2, 2, 16, 6)
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)

    def ours(q, k, v):
        o = attention.flash_attention_trainable(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    want = jax.grad(ours, argnums=(0, 1, 2))(
        *(jnp.asarray(x).astype("bfloat16") for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    out = tattn.flash_attention_trainable(tq, tk, tv, **kw)
    (out.float() ** 2).sum().backward()
    for a, b in zip(want, (tq.grad, tk.grad, tv.grad), strict=True):
        assert b.dtype == torch.bfloat16
        a = np.asarray(a, np.float32)
        rel = np.linalg.norm(b.float().numpy() - a) / np.linalg.norm(a)
        assert rel < 4e-2, rel


def _fwd64(q, k, v, causal, qc, kc):
    """The chunked plain forward in float64, in the kernels' layout."""
    B, H, Sq, d = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    o, lse = tattn._flash_fwd_lse(
        q.transpose(1, 2).reshape(B, Sq, Hkv, g, d), k.transpose(1, 2),
        v.transpose(1, 2), causal=causal, q_chunk=qc, kv_chunk=kc)
    return o.reshape(B, Sq, H, d).transpose(1, 2), lse.reshape(B, H, Sq)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_passes_gradcheck_in_float64(causal):
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 4, 8, 8), (1, 2, 8, 8), (1, 2, 8, 8)))
    fwd = functools.partial(_fwd64, qc=4, kc=4)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tattn.FlashAttentionFn.apply(a, b, c, causal, 4, 4,
                                                     fwd), (q, k, v))


def test_rmsnorm_function_passes_gradcheck_in_float64():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((5, 16))).requires_grad_()
    s = torch.from_numpy(rng.standard_normal(16)).requires_grad_()

    def fwd(x, scale, eps):      # the plain formula, in float64
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
            1.0 + scale)

    assert torch.autograd.gradcheck(
        lambda a, b: tcommon.RMSNormFn.apply(a, b, 1e-5, fwd), (x, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_grads_match_the_reference(dtype):
    jax, jnp, _, common = _jax()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    w = rng.standard_normal((2, 5, 32)).astype(np.float32)

    def f(x, s):
        return jnp.sum(common.rmsnorm(x, s, 1e-5).astype(jnp.float32) * w)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x).astype(dtype),
                                       jnp.asarray(scale))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    (tcommon.rmsnorm(tx, ts, 1e-5).float() * torch.from_numpy(w)
     ).sum().backward()
    assert tx.grad.dtype == tx.dtype and ts.grad.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    for a, b in ((want[0], tx.grad), (want[1], ts.grad)):
        a = np.asarray(a, np.float32)
        rel = np.linalg.norm(b.float().numpy() - a) / np.linalg.norm(a)
        assert rel < tol, rel


def test_rmsnorm_without_grad_is_the_kernel_call():
    x = torch.randn(3, 4, 16)
    s = torch.randn(16)
    with torch.no_grad():
        got = tcommon.rmsnorm(x, s, 1e-5)
    want = ops.rmsnorm(x.reshape(-1, 16), s, eps=1e-5).reshape(x.shape)
    assert torch.equal(got, want)


# ---- each route's lse -----------------------------------------------------
#: (B, H, Hkv, Sq, Skv, dtype, causal) reaching each route's plain version
LSE_CASES = {"simt": (2, 4, 2, 40, 40, torch.float32, True),
             "simt-noncausal": (1, 4, 2, 9, 70, torch.float32, False),
             "tc": (2, 4, 2, 40, 40, torch.bfloat16, True),
             "decode": (2, 4, 2, 1, 90, torch.float32, False),
             "decode-prompt": (1, 4, 4, 3, 3, torch.bfloat16, True)}


@pytest.mark.parametrize("name", list(LSE_CASES))
def test_each_route_gives_the_rows_logsumexp(name):
    B, H, Hkv, Sq, Skv, dtype, causal = LSE_CASES[name]
    g = torch.Generator().manual_seed(11)
    q = torch.randn(B, H, Sq, 16, generator=g).to(dtype)
    k = torch.randn(B, Hkv, Skv, 16, generator=g).to(dtype)
    v = torch.randn(B, Hkv, Skv, 16, generator=g).to(dtype)
    assert tfa.route(q, k, v) == name.split("-")[0]
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    out, lse = ops.flash_attention(q, k, v, with_lse=True, **kw)
    # the output is the call's without lse, bit for bit
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    want_o, want_l = ops.flash_attention(q, k, v, mode="ref", with_lse=True,
                                         causal=causal)
    np.testing.assert_allclose(lse.numpy(), want_l.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(want_o, tref.flash_attention_ref(q, k, v,
                                                        causal=causal))
