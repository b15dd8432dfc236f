"""The port's dense decoder against the reference's, on the CPU.

Both sides take the same parameters: the reference's ``init_params``,
with its norm scales and QKV biases (zeros at init) drawn at random so
they count, carried across by ``carry.params_from_reference``.  On CPU
tensors the port's RMSNorm and flash attention run their kernels' plain
versions.  Logits are held to ``tests/test_models.py``'s 5e-5 max-abs in
float32; greedy tokens agree wherever the reference's top-1 / top-2
margin exceeds that tolerance (the count of steps under it is printed).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

TOL = 5e-5
#: the bfloat16 qwen2-0.5b smoke model's logits and cache against the
#: reference's: measured on the CPU at most 1.56e-2 over seeds 0-5
#: (forward, prefill, cache and decode; 3.1e-2 for granite-3-2b's smoke
#: model).  Both sides round every product and sum to bfloat16, where
#: XLA and torch may land a value on neighbouring bfloat16 values
BF16_TOL = 4e-2
ARCHS = ["qwen2-0.5b", "granite-3-2b", "cupbop-demo-120m"]
#: the smoke qwen2-0.5b with padded heads: 6 q / 2 kv heads at tp_align 4
#: (scheme A: kv heads duplicated, 2 dummy q heads), and 3 / 3 at 4
#: (scheme B: a dummy kv head and its dummy q head)
PADDED = {"padded-6q2kv": dict(num_heads=6, num_kv_heads=2, head_dim=16,
                               tp_align=4),
          "padded-3q3kv": dict(num_heads=3, num_kv_heads=3, head_dim=16,
                               tp_align=4)}
EXCLUDED = ["grok-1-314b", "deepseek-moe-16b", "zamba2-7b", "rwkv6-1.6b",
            "musicgen-medium", "internvl2-76b"]
#: the families of EXCLUDED ported since (experts, codebooks, a patch
#: prefix, the state-space and RWKV mixers): all of them
PORTED = ["grok-1-314b", "deepseek-moe-16b", "musicgen-medium",
          "internvl2-76b", "zamba2-7b", "rwkv6-1.6b"]


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.models import attention, common, mlp, transformer
    return jax, jnp, registry, attention, common, mlp, transformer


def _cfgs(name):
    """(reference config, port config) for an arch or a padded variant."""
    _, _, reg, *_ = _jax()
    if name in PADDED:
        kw = PADDED[name]
        return (reg.smoke("qwen2-0.5b").replace(**kw),
                treg.smoke("qwen2-0.5b").replace(**kw))
    return reg.smoke(name), treg.smoke(name)


def _perturb(tree, rng):
    """Norm scales and QKV biases drawn at random, in their dtypes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
            noise = 0.5 * rng.standard_normal(v.shape).astype(np.float32)
            out[k] = (np.asarray(v, np.float32) + noise).astype(v.dtype)
        else:
            out[k] = v
    return out


def _params(ref_cfg, seed=0):
    """The reference's parameters (perturbed) on both sides."""
    jax, jnp, _, _, _, _, T = _jax()
    host = jax.tree.map(np.asarray, T.init_params(ref_cfg,
                                                  jax.random.PRNGKey(seed)))
    host = _perturb(host, np.random.default_rng(seed + 100))
    return (jax.tree.map(jnp.asarray, host),
            carry.params_from_reference(host, device="cpu"))


def _toks(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(cfg, B, S, seed=0):
    """``tests/test_archs.py``'s batch: ``[B, S]`` tokens (``[B, S, K]``
    with codebooks) and, with a patch prefix, ``patch_embeds``."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape)
             .astype(np.int32)}
    if cfg.patch_prefix:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.patch_prefix, cfg.d_model)).astype(np.float32) * 0.02
    return batch


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _gap(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _margin_check(mine, ref, tol, vocab):
    """Greedy tokens of ``mine`` equal the reference's wherever the
    reference's top-1 / top-2 margin exceeds ``tol``; returns the count of
    rows under it."""
    ref, mine = _np(ref)[..., :vocab], _np(mine)[..., :vocab]
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert (mine.argmax(-1) == ref.argmax(-1))[clear].all()
    return int((~clear).sum())


# ---- primitives ---------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_the_reference(dtype):
    _, jnp, _, _, common, _, _ = _jax()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = common.rmsnorm(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                          1e-5)
    got = tcommon.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(scale), 1e-5)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert _gap(got, want) <= (1e-5 if dtype == "float32" else 2e-2)


def test_rope_matches_the_reference():
    _, jnp, _, _, common, _, _ = _jax()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = common.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        assert _gap(got, want) <= TOL


def test_dense_silu_and_mlp_match_the_reference():
    jax, jnp, reg, _, common, mlp, _ = _jax()
    cfg = reg.smoke("qwen2-0.5b")
    p = jax.tree.map(np.asarray, mlp.init_mlp_params(
        jax.random.PRNGKey(3), cfg.d_model, cfg.d_ff, cfg.pdtype))
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)
                                                 ).astype(np.float32)
    want = mlp.mlp_block(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tmlp.mlp_block(treg.smoke("qwen2-0.5b"),
                         carry.params_from_reference(p, device="cpu"),
                         torch.from_numpy(x))
    assert _gap(got, want) <= TOL
    assert _gap(tcommon.silu(torch.from_numpy(x)),
                common.silu(jnp.asarray(x))) <= 1e-6


@pytest.mark.parametrize("name", ARCHS[:1] + list(PADDED))
def test_attend_full_matches_the_reference(name):
    jax, jnp, _, attention, _, _, _ = _jax()
    ref_cfg, cfg = _cfgs(name)
    host = jax.tree.map(np.asarray, attention.init_attn_params(
        jax.random.PRNGKey(4), ref_cfg))
    host = _perturb(host, np.random.default_rng(5))
    B, S = 2, 24
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, (wk, wv) = attention.attend_full(
        ref_cfg, attention.plan_for(ref_cfg),
        jax.tree.map(jnp.asarray, host), jnp.asarray(x), jnp.asarray(pos))
    got, (k, v) = tattn.attend_full(
        cfg, tattn.plan_for(cfg), carry.params_from_reference(host,
                                                              device="cpu"),
        torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert got.shape == want.shape and k.shape == wk.shape
    assert max(_gap(got, want), _gap(k, wk), _gap(v, wv)) <= TOL


@pytest.mark.parametrize("pos", [0, 9, 31])
@pytest.mark.parametrize("name", ARCHS[:1] + list(PADDED))
def test_attend_decode_matches_the_reference(name, pos):
    jax, jnp, _, attention, _, _, _ = _jax()
    ref_cfg, cfg = _cfgs(name)
    plan = tattn.plan_for(cfg)
    host = jax.tree.map(np.asarray, attention.init_attn_params(
        jax.random.PRNGKey(7), ref_cfg))
    host = _perturb(host, np.random.default_rng(8))
    rng = np.random.default_rng(9)
    B, Smax = 3, 32
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, plan.hkv_p, cfg.hd)).astype(np.float32)
    vc = rng.standard_normal((B, Smax, plan.hkv_p, cfg.hd)).astype(np.float32)
    want, wk, wv = attention.attend_decode(
        ref_cfg, attention.plan_for(ref_cfg), jax.tree.map(jnp.asarray, host),
        jnp.asarray(x1), jnp.asarray(kc), jnp.asarray(vc), pos)
    k_cache, v_cache = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, k2, v2 = tattn.attend_decode(
        cfg, plan, carry.params_from_reference(host, device="cpu"),
        torch.from_numpy(x1), k_cache, v_cache, pos)
    assert k2 is k_cache and v2 is v_cache        # written in place
    assert max(_gap(got, want), _gap(k2, wk), _gap(v2, wv)) <= TOL


def test_attend_decode_past_the_cache_end_clamps_as_the_reference():
    """The reference's dynamic_update_slice clamps a start past the end:
    the step writes the last row and attends to every row."""
    jax, jnp, _, attention, _, _, _ = _jax()
    ref_cfg, cfg = _cfgs("qwen2-0.5b")
    plan = tattn.plan_for(cfg)
    host = jax.tree.map(np.asarray, attention.init_attn_params(
        jax.random.PRNGKey(10), ref_cfg))
    rng = np.random.default_rng(11)
    B, Smax = 2, 12
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, Smax, plan.hkv_p, cfg.hd)).astype(np.float32)
    for pos in (Smax, Smax + 5):
        want, wk, _ = attention.attend_decode(
            ref_cfg, attention.plan_for(ref_cfg),
            jax.tree.map(jnp.asarray, host), jnp.asarray(x1),
            jnp.asarray(kc), jnp.asarray(kc), pos)
        got, k2, _ = tattn.attend_decode(
            cfg, plan, carry.params_from_reference(host, device="cpu"),
            torch.from_numpy(x1), torch.from_numpy(kc.copy()),
            torch.from_numpy(kc.copy()), pos)
        assert max(_gap(got, want), _gap(k2, wk)) <= TOL


# ---- the model ----------------------------------------------------------
def _logits_against_reference(name, tol, B=2, S=16, seed=0):
    """forward, prefill and teacher-forced decode steps on both sides:
    the max-abs gaps, checked at ``tol``, and the margin rule."""
    jax, jnp, _, _, _, _, T = _jax()
    ref_cfg, cfg = _cfgs(name)
    if tol == BF16_TOL:
        ref_cfg = ref_cfg.replace(param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
        cfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref_p, p = _params(ref_cfg, seed)
    toks = _toks(cfg, B, S, seed)
    want_full, _ = T.forward(ref_cfg, ref_p, {"tokens": toks})
    got_full, aux = tT.forward(cfg, p, {"tokens": toks})
    assert got_full.shape == want_full.shape and got_full.dtype == torch.float32
    assert float(aux) == 0.0
    gaps = {"forward": _gap(got_full, want_full)}
    under = _margin_check(got_full, want_full, tol, cfg.vocab_size)
    Sp = S - 4
    want, rcache = T.prefill(ref_cfg, ref_p, {"tokens": toks[:, :Sp]},
                             max_len=S)
    got, cache = tT.prefill(cfg, p, {"tokens": toks[:, :Sp]}, max_len=S)
    assert cache["pos"] == Sp and got.shape == want.shape
    gaps["prefill"] = _gap(got, want)
    gaps["cache"] = max(_gap(cache["k"], rcache["k"]),
                        _gap(cache["v"], rcache["v"]))
    under += _margin_check(got, want, tol, cfg.vocab_size)
    for t in range(Sp, S):                  # fed the same tokens
        want, rcache = T.decode_step(ref_cfg, ref_p, rcache,
                                     jnp.asarray(toks[:, t:t + 1]))
        got, cache = tT.decode_step(cfg, p, cache, toks[:, t:t + 1])
        gaps[f"decode{t}"] = _gap(got, want)
        under += _margin_check(got, want, tol, cfg.vocab_size)
    assert cache["pos"] == S
    print(f"{name}: max-abs gaps {gaps}; rows under the margin {under}")
    assert max(gaps.values()) <= tol, gaps
    return gaps


@pytest.mark.parametrize("name", ARCHS + list(PADDED))
def test_logits_match_the_reference(name):
    _logits_against_reference(name, TOL)


def test_bfloat16_logits_match_the_reference():
    gaps = _logits_against_reference("qwen2-0.5b", BF16_TOL)
    assert max(gaps.values()) > 0       # bfloat16 does round differently


@pytest.mark.parametrize("name", ARCHS + ["padded-6q2kv"])
def test_prefill_then_decode_equals_forward(name):
    """The port alone, on its own init: tests/test_models.py's
    consistency check."""
    _, cfg = _cfgs(name)
    p = tT.init_params(cfg, 1, device="cpu")
    B, S = 2, 16
    toks = _toks(cfg, B, S)
    full, _ = tT.forward(cfg, p, {"tokens": toks})
    Sp = S - 4
    lg, cache = tT.prefill(cfg, p, {"tokens": toks[:, :Sp]}, max_len=S)
    errs = [_gap(lg[:, 0], full[:, Sp - 1])]
    for t in range(Sp, S):
        lg, cache = tT.decode_step(cfg, p, cache, toks[:, t:t + 1])
        errs.append(_gap(lg[:, 0], full[:, t]))
    assert max(errs) < TOL, errs


def test_decode_cache_isolation():
    """Tokens fed to one batch row don't leak into another row's logits."""
    cfg = treg.smoke("qwen2-0.5b")
    p = tT.init_params(cfg, 0, device="cpu")
    toksA = _toks(cfg, 2, 8, seed=1)
    toksB = toksA.copy()
    toksB[1] = (toksB[1] + 7) % cfg.vocab_size   # change only row 1
    _, cacheA = tT.prefill(cfg, p, {"tokens": toksA}, max_len=12)
    _, cacheB = tT.prefill(cfg, p, {"tokens": toksB}, max_len=12)
    nxt = toksA[:, :1]
    lgA, _ = tT.decode_step(cfg, p, cacheA, nxt)
    lgB, _ = tT.decode_step(cfg, p, cacheB, nxt)
    np.testing.assert_allclose(_np(lgA[0]), _np(lgB[0]), rtol=1e-5,
                               atol=1e-5)   # row 0 unchanged
    assert np.abs(_np(lgA[1]) - _np(lgB[1])).max() > 1e-3


def test_a_decode_step_may_be_retaken_from_the_cache_it_was_given():
    cfg = treg.smoke("granite-3-2b")
    p = tT.init_params(cfg, 2, device="cpu")
    toks = _toks(cfg, 2, 9, seed=3)
    _, cache = tT.prefill(cfg, p, {"tokens": toks[:, :8]}, max_len=12)
    first, nxt = tT.decode_step(cfg, p, cache, toks[:, 8:])
    again, _ = tT.decode_step(cfg, p, cache, toks[:, 8:])
    assert cache["pos"] == 8 and nxt["pos"] == 9
    assert torch.equal(first, again)


def test_init_matches_the_reference_shapes_dtypes_and_bounds():
    jax, _, reg, _, _, _, T = _jax()
    for name, kw in (("qwen2-0.5b", PADDED["padded-6q2kv"]),
                     ("granite-3-2b", PADDED["padded-3q3kv"])):
        ref_cfg = reg.smoke(name).replace(param_dtype="bfloat16", **kw)
        cfg = treg.smoke(name).replace(param_dtype="bfloat16", **kw)
        want = jax.tree.map(np.asarray, T.init_params(
            ref_cfg, jax.random.PRNGKey(0)))
        got = tT.init_params(cfg, 0, device="cpu")

        def walk(w, g, path=""):
            assert set(w) == set(g), path
            for k in w:
                if isinstance(w[k], dict):
                    walk(w[k], g[k], f"{path}/{k}")
                    continue
                assert tuple(g[k].shape) == w[k].shape, f"{path}/{k}"
                mine = str(g[k].dtype).removeprefix("torch.")
                if k in ("wq", "wk", "wv", "wo"):
                    # the reference's dummy-slot mask promotes these
                    assert mine == "bfloat16", f"{path}/{k}"
                    assert w[k].dtype.name in (mine, "float32"), f"{path}/{k}"
                else:
                    assert mine == w[k].dtype.name, f"{path}/{k}"
                bound = float(np.abs(np.asarray(w[k], np.float32)).max())
                gbound = float(g[k].float().abs().max())
                if bound == 0:
                    assert gbound == 0, f"{path}/{k}"
                else:   # uniform draws of the same bound
                    assert 0.9 * bound <= gbound <= bound * 1.01, f"{path}/{k}"
        walk(want, got)
        # the dummy heads' slots are zero on both sides
        plan = tattn.plan_for(cfg)
        dummy = [i for i, m in enumerate(plan.qmap) if m < 0]
        wq = got["layers"]["attn"]["wq"].reshape(cfg.num_layers, cfg.d_model,
                                                 plan.hq_p, cfg.hd)
        assert dummy and not wq[:, :, dummy].any()


def test_init_is_seeded():
    cfg = treg.smoke("qwen2-0.5b")
    a = tT.init_params(cfg, 5, device="cpu")
    b = tT.init_params(cfg, 5, device="cpu")
    c = tT.init_params(cfg, 6, device="cpu")
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert not torch.equal(a["layers"]["mlp"]["w_up"],
                           c["layers"]["mlp"]["w_up"])


def test_params_from_reference_keeps_keys_layouts_and_bits():
    jax, _, reg, _, _, _, T = _jax()
    cfg = reg.smoke("qwen2-0.5b").replace(param_dtype="bfloat16")
    host = jax.tree.map(np.asarray, T.init_params(cfg,
                                                  jax.random.PRNGKey(1)))
    got = carry.params_from_reference(host, device="cpu")
    tok = got["embed"]["tok"]
    assert tok.dtype == torch.bfloat16
    assert np.array_equal(tok.view(torch.int16).numpy(),
                          host["embed"]["tok"].view(np.int16))
    assert tuple(got["layers"]["mlp"]["w_gate"].shape) == \
        host["layers"]["mlp"]["w_gate"].shape
    assert got["layers"]["ln1"].dtype == torch.float32


@pytest.mark.parametrize("arch", EXCLUDED)
def test_excluded_families_raise_naming_the_roadmap(arch):
    """The six archs the dense slice refused, each ported since (experts,
    codebooks, a patch prefix, the state-space and RWKV mixers), run
    through the five entry points."""
    assert arch in PORTED
    cfg = treg.smoke(arch)
    batch = _batch(cfg, 1, 4)
    toks = batch["tokens"]
    p = tT.init_params(cfg, 0, device="cpu")
    assert tT.init_cache(cfg, 1, 8 + cfg.patch_prefix,
                         device="cpu")["pos"] == 0
    logits, aux = tT.forward(cfg, p, batch)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    lg, cache = tT.prefill(cfg, p, batch, 8 + cfg.patch_prefix)
    assert cache["pos"] == 4 + cfg.patch_prefix
    lg, cache = tT.decode_step(cfg, p, cache, toks[:, :1])
    assert torch.isfinite(lg).all() and cache["pos"] == 5 + \
        cfg.patch_prefix


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-3-2b",
                                  "deepseek-moe-16b", "musicgen-medium",
                                  "internvl2-76b"])
def test_init_draws_the_stacked_layers_bit_for_bit_as_before(arch):
    """init_params fills leaves allocated once, layer by layer: for a
    given seed every value is the old path's, which built every layer
    and then stacked them (so earlier seeds' weights do not move)."""
    cfg = treg.smoke(arch).replace(param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(7)
    D, Vp, K = cfg.d_model, cfg.padded_vocab, cfg.num_codebooks
    want = {"embed": ({"codebooks": tcommon.uniform_init(
        gen, (K, Vp, D), 1.0, cfg.pdtype)} if K > 1 else
        {"tok": tcommon.uniform_init(gen, (Vp, D), 1.0, cfg.pdtype)})}
    if cfg.patch_prefix:
        want["embed"]["patch_proj"] = tcommon.uniform_init(
            gen, (D, D), 1.0, cfg.pdtype)
    layers = [tT._init_layer(cfg, gen) for _ in range(cfg.num_layers)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    want["layers"] = stack(layers)
    want["final_norm"] = torch.zeros(D)
    if K > 1:
        want["lm_heads"] = tcommon.uniform_init(gen, (K, D, Vp), 1.0,
                                                cfg.pdtype)
    elif not cfg.tie_embeddings:
        want["lm_head"] = tcommon.uniform_init(gen, (D, Vp), 1.0,
                                               cfg.pdtype)
    got = tT.init_params(cfg, 7, device="cpu")

    def walk(w, g, path=""):
        assert set(w) == set(g), path
        for k in w:
            if isinstance(w[k], dict):
                walk(w[k], g[k], f"{path}/{k}")
            else:
                assert g[k].dtype == w[k].dtype, f"{path}/{k}"
                assert torch.equal(g[k], w[k]), f"{path}/{k}"
    walk(want, got)
