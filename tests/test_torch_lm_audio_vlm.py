"""The port's audio (several codebooks) and VLM (a patch prefix) inputs
against the reference's, on the CPU.

musicgen-medium's smoke model (4 codebooks: summed embeddings, a head a
codebook, ``[B, S, K, Vp]`` logits) and internvl2-76b's (8 projected
patch embeddings in front of the tokens) on the reference's parameters:
forward, prefill and teacher-forced decode logits within 5e-5 (loss and
gradients are held in ``tests/test_torch_lm_grads.py``); the codebook sum
in bfloat16 bit for bit; out-of-range codebook ids gathered and
differentiated by F8's rule; the new leaves' shapes, dtypes and bounds;
the ``Engine`` on internvl2's text against the reference's, and on
musicgen refused, as the reference's cannot take codebook tokens either.
The ``Engine`` and ``serve --lm`` on the two expert configs (grok-1-314b,
deepseek-moe-16b) against the reference's too.  Each reference result is
computed once per module.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from test_torch_lm_engine import (TRAFFIC, _compare,  # noqa: E402
                                  _force_port, _record_reference, _submit)
from test_torch_lm_models import TOL, _batch, _gap, _params  # noqa: E402

ARCHS = ["musicgen-medium", "internvl2-76b"]
MOE_ARCHS = ["grok-1-314b", "deepseek-moe-16b"]


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.models import transformer
    return jax, jnp, registry, transformer


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _reference(arch, B=2, S=12):
    """The reference's forward, prefill (with the patch prefix) and
    teacher-forced decode steps on its perturbed parameters."""
    jax, jnp, reg, T = _jax()
    rc = reg.smoke(arch)
    ref_p, _ = _params(rc, 0)
    host = jax.tree.map(np.asarray, ref_p)
    batch = _batch(rc, B, S, seed=1)
    full, _ = jax.jit(lambda p, b: T.forward(rc, p, b))(ref_p, batch)
    Sp = S - 3
    pre_batch = {k: v[:, :Sp] if k == "tokens" else v
                 for k, v in batch.items()}
    max_len = S + rc.patch_prefix
    pre, cache = jax.jit(lambda p, b: T.prefill(rc, p, b, max_len=max_len))(
        ref_p, pre_batch)
    dec = jax.jit(lambda p, c, t: T.decode_step(rc, p, c, t))
    steps = []
    for t in range(Sp, S):
        lg, cache = dec(ref_p, cache, jnp.asarray(batch["tokens"][:, t:t + 1]))
        steps.append(_np(lg))
    return host, batch, _np(full), _np(pre), steps, _np(cache["k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_the_reference(arch):
    host, batch, full, pre, steps, wk = _reference(arch)
    cfg = treg.smoke(arch)
    p = carry.params_from_reference(host, device="cpu")
    got, aux = tT.forward(cfg, p, batch)
    assert got.shape == full.shape and float(aux) == 0.0
    gaps = {"forward": _gap(got, full)}
    S = batch["tokens"].shape[1]
    Sp = S - 3
    pre_batch = {k: v[:, :Sp] if k == "tokens" else v
                 for k, v in batch.items()}
    lg, cache = tT.prefill(cfg, p, pre_batch, max_len=S + cfg.patch_prefix)
    assert cache["pos"] == Sp + cfg.patch_prefix
    gaps["prefill"] = _gap(lg, pre)
    for j, t in enumerate(range(Sp, S)):
        lg, cache = tT.decode_step(cfg, p, cache,
                                   batch["tokens"][:, t:t + 1])
        gaps[f"decode{t}"] = _gap(lg, steps[j])
    gaps["cache"] = _gap(cache["k"], wk)
    print(f"{arch}: gaps {gaps}")
    assert max(gaps.values()) <= TOL, gaps
    if cfg.num_codebooks > 1:
        assert tuple(lg.shape) == (2, 1, cfg.num_codebooks, cfg.padded_vocab)


def test_codebook_sum_is_the_references_bfloat16_bits():
    """The parts added in codebook order in the parameters' dtype, then
    cast: the reference's ``sum(parts)``, bit for bit."""
    jax, jnp, reg, T = _jax()
    rc = reg.smoke("musicgen-medium").replace(param_dtype="bfloat16",
                                              compute_dtype="bfloat16")
    host = jax.tree.map(np.asarray, {"embed": T.init_params(
        rc, jax.random.PRNGKey(2))["embed"]})
    toks = _batch(rc, 2, 16, seed=2)["tokens"]
    want = np.asarray(T.embed(rc, jax.tree.map(jnp.asarray, host),
                              {"tokens": toks}), np.float32)
    got = tT.embed(treg.smoke("musicgen-medium").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16"),
        carry.params_from_reference(host, device="cpu"), {"tokens": toks})
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_out_of_range_codebook_ids_follow_f8():
    """Ids at and past the padded vocabulary clamp, negative ones wrap
    once then clamp, in every codebook (JAX's gather); each codebook's
    gradient drops the rows of ids still out of range after the wrap, as
    ``jax.grad`` of the reference's embed does."""
    jax, jnp, reg, T = _jax()
    rc, cfg = reg.smoke("musicgen-medium"), treg.smoke("musicgen-medium")
    host = jax.tree.map(np.asarray, _params(rc, 3)[0])
    Vp = cfg.padded_vocab
    odd = np.array([1, Vp, Vp + 5, -1, -Vp - 3, 7, -Vp, Vp - 1], np.int32)
    toks = np.stack([np.roll(odd, k) for k in range(4)], -1)[None]
    w = np.random.default_rng(3).standard_normal(
        (1, odd.size, cfg.d_model)).astype(np.float32)

    def f(books):
        return jnp.sum(T.embed(rc, {"embed": {"codebooks": books}},
                               {"tokens": toks}) * w)

    want_x = np.asarray(T.embed(rc, jax.tree.map(jnp.asarray, host),
                                {"tokens": toks}))
    want_g = np.asarray(jax.grad(f)(jnp.asarray(host["embed"]["codebooks"])))
    p = carry.params_from_reference(host, device="cpu")
    books = p["embed"]["codebooks"].requires_grad_(True)
    x = tT.embed(cfg, p, {"tokens": toks})
    assert np.array_equal(x.detach().numpy(), want_x)
    (x * torch.from_numpy(w)).sum().backward()
    assert np.array_equal(books.grad.numpy(), want_g)
    full, _ = jax.jit(lambda q: T.forward(rc, q, {"tokens": toks}))(host)
    p = carry.params_from_reference(host, device="cpu")
    assert _gap(tT.forward(cfg, p, {"tokens": toks})[0], full) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_new_leaves_match_the_reference_shapes_dtypes_and_bounds(arch):
    jax, _, reg, T = _jax()
    rc = reg.smoke(arch).replace(param_dtype="bfloat16", num_layers=1)
    want = jax.tree.map(np.asarray, T.init_params(rc, jax.random.PRNGKey(0)))
    got = tT.init_params(treg.smoke(arch).replace(
        param_dtype="bfloat16", num_layers=1), 0, device="cpu")
    assert set(got) == set(want) and set(got["embed"]) == set(want["embed"])
    new = [("embed", "codebooks"), ("embed", "patch_proj"), ("lm_heads",)]
    seen = 0
    for path in new:
        w, g = want, got
        for k in path:
            w, g = w.get(k, {}), g.get(k, {})
        if isinstance(w, dict):
            assert g == {}, path
            continue
        seen += 1
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        bound = float(np.abs(w.astype(np.float32)).max())
        assert 0.9 * bound <= float(g.float().abs().max()) <= bound * 1.01
    assert seen == (2 if arch == "musicgen-medium" else 1)


def test_engine_on_internvl2_text_matches_the_reference():
    """The engine's prompts are text (the reference's prefill gets no
    patch embeddings from it): both engines on the reference's
    parameters, the port fed the reference's tokens."""
    jax, _, reg, T = _jax()
    from repro.serve.engine import Engine
    slots, max_len, n, prompt_len, max_new, pos = TRAFFIC["system"]
    rc = reg.smoke("internvl2-76b")
    params = T.init_params(rc, jax.random.PRNGKey(0))
    p = carry.params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    cfg = treg.smoke("internvl2-76b")
    ref = Engine(rc, params, slots=slots, max_len=max_len)
    rec_ref = _record_reference(ref, rc)
    ref_reqs = _submit(ref, rc, n, prompt_len, max_new, 0)
    ref.run(max_steps=200)
    eng = TEngine(cfg, p, slots=slots, max_len=max_len, device="cpu")
    rec = _force_port(eng, cfg, rec_ref)
    reqs = _submit(eng, cfg, n, prompt_len, max_new, 0)
    eng.run(max_steps=200)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert eng.stats == ref.stats and eng.cache["pos"] == pos
    gp, _ = _compare(rec["prefill"], rec_ref["prefill"], rc.vocab_size)
    gd, _ = _compare(rec["decode"], rec_ref["decode"], rc.vocab_size)
    assert max(gp, gd) <= TOL


def test_engine_refuses_codebook_tokens_as_the_reference_cannot_serve_them():
    jax, _, reg, T = _jax()
    from repro.serve.engine import Engine
    rc = reg.smoke("musicgen-medium")
    ref = Engine(rc, T.init_params(rc, jax.random.PRNGKey(0)), slots=2,
                 max_len=16)
    ref.submit(np.zeros((4, rc.num_codebooks), np.int32), max_new=2)
    with pytest.raises(Exception):
        ref.run(max_steps=4)
    cfg = treg.smoke("musicgen-medium")
    with pytest.raises(NotImplementedError, match="one token a slot"):
        TEngine(cfg, tT.init_params(cfg, 0, device="cpu"), slots=2,
                max_len=16, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_serves_the_experts_as_the_reference(arch):
    """tests/test_system.py's traffic through both engines on the
    reference's parameters, the port fed the reference's tokens: logits
    within 5e-5, tokens and stats equal."""
    jax, _, reg, T = _jax()
    from repro.serve.engine import Engine
    slots, max_len, n, prompt_len, max_new, pos = TRAFFIC["system"]
    rc = reg.smoke(arch)
    params = T.init_params(rc, jax.random.PRNGKey(0))
    p = carry.params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    cfg = treg.smoke(arch)
    ref = Engine(rc, params, slots=slots, max_len=max_len)
    rec_ref = _record_reference(ref, rc)
    ref_reqs = _submit(ref, rc, n, prompt_len, max_new, 0)
    ref.run(max_steps=200)
    eng = TEngine(cfg, p, slots=slots, max_len=max_len, device="cpu")
    rec = _force_port(eng, cfg, rec_ref)
    reqs = _submit(eng, cfg, n, prompt_len, max_new, 0)
    eng.run(max_steps=200)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert eng.stats == ref.stats and eng.cache["pos"] == pos
    gp, up = _compare(rec["prefill"], rec_ref["prefill"], rc.vocab_size)
    gd, ud = _compare(rec["decode"], rec_ref["decode"], rc.vocab_size)
    print(f"{arch}: prefill gap {gp}, decode gap {gd}, under {up + ud}")
    assert max(gp, gd) <= TOL


def test_serve_lm_command_serves_the_experts_as_the_reference():
    """``serve --lm --arch deepseek-moe-16b`` (the smoke config, as the
    reference's) serves every request and counts as the reference's."""
    from repro.launch import serve
    from repro_torch.launch import serve as tserve
    argv = ["--lm", "--arch", "deepseek-moe-16b", "--requests", "4",
            "--max-new", "4"]
    assert tserve.main(argv + ["--device", "cpu"]) == serve.main(argv)
