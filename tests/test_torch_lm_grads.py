"""The port's ``loss_fn`` and its gradients against the reference's
``jax.value_and_grad(T.loss_fn)``, on the CPU.

Both sides take the reference's parameters (norm scales and QKV biases
drawn at random so they count), carried across by
``carry.params_from_reference``; on CPU tensors the port's RMSNorm and
flash forwards run their kernels' plain versions.  In float32 on the
smoke configs of the five dense archs, the two padded variants of
``tests/test_torch_lm_models.py`` and the four archs ported since (the
experts' aux term, codebooks, a patch prefix): the loss within 1e-5
relative and every gradient leaf within 1e-4 of its norm (``||dg|| /
||g||``).  remat ``none``, ``full`` and ``dots`` give
the same loss and gradients; a bfloat16 config (the gradient cast before
the head) holds the reference within the bfloat16 tolerance of
``tests/test_torch_lm_models.py`` (4e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from test_torch_lm_models import PADDED, _batch, _params, _toks  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_TOL = 4e-2
DENSE = ["qwen2-0.5b", "granite-3-2b", "minicpm-2b", "qwen2.5-32b",
         "cupbop-demo-120m"]
#: the families ported since: experts (their aux term in the loss), the
#: codebooks' summed embeddings and heads, the patch prefix
LATER = ["grok-1-314b", "deepseek-moe-16b", "musicgen-medium",
         "internvl2-76b"]


def _jax():
    import jax

    from repro.configs import registry
    from repro.models import transformer
    return jax, registry, transformer


def _cfgs(name, **kw):
    _, reg, _ = _jax()
    if name in PADDED:
        kw = {**PADDED[name], **kw}
        name = "qwen2-0.5b"
    return reg.smoke(name).replace(**kw), treg.smoke(name).replace(**kw)


def _as_batch(toks):
    return toks if isinstance(toks, dict) else {"tokens": toks}


def _reference(ref_cfg, ref_p, toks):
    """(loss, {path: grad}) of the reference, leaves in its order;
    ``toks`` the tokens or a whole batch."""
    jax, _, T = _jax()
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: T.loss_fn(ref_cfg, p, _as_batch(toks)), has_aux=True))(
        ref_p)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return float(loss), [(jax.tree_util.keystr(k), np.asarray(g, np.float32))
                         for k, g in flat]


def _port(cfg, p, toks):
    """(loss, grads in the reference's leaf order, metrics)."""
    leaves = tadam.tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = tT.loss_fn(cfg, p, _as_batch(toks))
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), [g.float().numpy() for g in grads], metrics


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", DENSE + list(PADDED) + LATER)
def test_loss_and_every_grad_leaf_match_the_reference(name):
    ref_cfg, cfg = _cfgs(name)
    ref_p, p = _params(ref_cfg, 1)
    toks = (_toks(cfg, 2, 24, seed=1) if name not in LATER
            else _batch(cfg, 2, 24, seed=1))
    want, wgrads = _reference(ref_cfg, ref_p, toks)
    got, grads, metrics = _port(cfg, p, toks)
    aux = float(metrics["aux"].detach())
    assert (aux == 0.0) == (cfg.moe is None)
    assert float((metrics["ce"] + 0.01 * metrics["aux"]).detach()) == got
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    assert len(grads) == len(wgrads)
    worst = {path: _rel(g, w) for (path, w), g in zip(wgrads, grads, strict=True)}
    print(f"{name}: loss {got} vs {want}; worst leaf "
          f"{max(worst, key=worst.get)} {max(worst.values())}")
    assert max(worst.values()) <= GRAD_RTOL, worst


@pytest.mark.parametrize("name", ["qwen2-0.5b", "padded-6q2kv"])
def test_remat_policies_give_the_same_loss_and_grads(name):
    _, cfg = _cfgs(name)
    p = tT.init_params(cfg, 3, device="cpu")
    toks = _toks(cfg, 2, 16, seed=3)
    runs = {remat: _port(cfg.replace(remat=remat), p, toks)[:2]
            for remat in ("none", "full", "dots")}
    loss0, g0 = runs["none"]
    for remat in ("full", "dots"):
        loss, g = runs[remat]
        assert loss == loss0, remat
        for a, b in zip(g, g0, strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_remat_reruns_each_layer_in_the_backward():
    """full remat recomputes each layer's forward in the backward: the
    RMSNorm and flash calls of the layers run twice, the head's once."""
    from repro_torch.kernels import ops
    _, cfg = _cfgs("qwen2-0.5b")
    p = tT.init_params(cfg, 4, device="cpu")
    toks = _toks(cfg, 2, 16, seed=4)
    calls = {"rmsnorm": 0, "flash_attention": 0}
    real = {n: getattr(ops, n) for n in calls}

    def count(n):
        def fn(*a, **k):
            calls[n] += 1
            return real[n](*a, **k)
        return fn

    L = cfg.num_layers
    for remat, per in (("none", (2 * L + 1, L)),
                       ("full", (4 * L + 1, 2 * L)),
                       ("dots", (4 * L + 1, 2 * L))):
        calls.update(rmsnorm=0, flash_attention=0)
        try:
            for n in calls:
                setattr(ops, n, count(n))
            _port(cfg.replace(remat=remat), p, toks)
        finally:
            for n, fn in real.items():
                setattr(ops, n, fn)
        assert (calls["rmsnorm"], calls["flash_attention"]) == per, remat


@pytest.mark.parametrize("remat", ["none", "full"])
def test_bfloat16_loss_and_grads_follow_the_reference(remat):
    """A bfloat16 config takes the gradient cast before the head; both
    sides round every product to bfloat16."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat=remat)
    ref_cfg, cfg = _cfgs("qwen2-0.5b", **kw)
    ref_p, p = _params(ref_cfg, 2)
    toks = _toks(cfg, 2, 16, seed=2)
    want, wgrads = _reference(ref_cfg, ref_p, toks)
    got, grads, _ = _port(cfg, p, toks)
    assert abs(got - want) <= BF16_TOL * abs(want)
    worst = max(_rel(g, w) for (_, w), g in zip(wgrads, grads, strict=True))
    print(f"bfloat16 remat={remat}: loss {got} vs {want}, worst leaf {worst}")
    assert worst <= BF16_TOL


def test_grad_cast_rounds_the_cotangent_to_the_compute_dtype():
    x = torch.randn(4, 8, dtype=torch.float32, requires_grad=True)
    y = tT._grad_cast("bfloat16")(x)
    assert torch.equal(y, x)
    g = torch.randn(4, 8)
    (y * g).sum().backward()
    assert torch.equal(x.grad, g.bfloat16().float())


def test_embed_gathers_and_differentiates_as_jax_out_of_range():
    """F8: ids at and past the padded vocabulary clamp to its last row and
    ids below its negative wrap once, then clamp to row 0 (JAX's gather);
    their gradient is dropped, as JAX's transposed scatter drops it."""
    jax, _, T = _jax()
    import jax.numpy as jnp
    ref_cfg, cfg = _cfgs("qwen2-0.5b")
    ref_p, p = _params(ref_cfg, 5)
    Vp = cfg.padded_vocab
    ids = np.array([[1, Vp, Vp + 5, -1, -Vp - 3, 7, -Vp, Vp - 1]], np.int32)
    w = np.random.default_rng(5).standard_normal(
        (1, ids.shape[1], cfg.d_model)).astype(np.float32)

    def f(tok):
        e = {**ref_p, "embed": {"tok": tok}}
        return jnp.sum(T.embed(ref_cfg, e, {"tokens": ids}) * w)

    want_x = np.asarray(T.embed(ref_cfg, ref_p, {"tokens": ids}))
    want_g = np.asarray(jax.grad(f)(ref_p["embed"]["tok"]))
    tok = p["embed"]["tok"].requires_grad_(True)
    x = tT.embed(cfg, p, {"tokens": ids})
    assert np.array_equal(x.detach().numpy(), want_x)
    (x * torch.from_numpy(w)).sum().backward()
    assert np.array_equal(tok.grad.numpy(), want_g)
    # -Vp wraps to row 0, in range: its gradient lands there
    assert torch.equal(tok.grad[0], torch.from_numpy(w[0, 6]))
