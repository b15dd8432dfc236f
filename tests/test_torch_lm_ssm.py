"""The port's state-space mixers against the reference's, on the CPU:
zamba2-7b's Mamba2 layers with its shared attention (this file) and
rwkv6-1.6b (``tests/test_torch_lm_rwkv.py``, which takes its helpers
from here).

Both sides take the same parameters: the reference's ``init_params``,
with every leaf it starts at a constant (norm scales, the conv bias,
``A_log``, ``dt_bias``, ``D_skip``; RWKV's ``mu``, ``w_base``, ``u``,
``ln_x``) moved by noise so each counts, carried across by
``carry.params_from_reference``.  On CPU tensors the port's RMSNorm and
flash attention run their kernels' plain versions.  The reference's
results are computed once a module, jitted.

* Logits and every cache leaf of forward, prefill and teacher-forced
  decode steps within ``TOL`` (5e-5 max-abs) in float32; in bfloat16
  within ``BF16_TOL[arch]``.  Run eagerly on both sides, a bfloat16
  Mamba2 mixer gives the reference's bits and an RWKV mixer lands within
  one bfloat16 step of them (``test_bfloat16_modules_*``); under
  ``lax.scan`` and ``jit`` XLA fuses chains of bfloat16 element-wise ops
  and rounds once at their end, where the port rounds each op, and the
  layers carry that into the logits.  ``BF16_TOL`` is 1.5 times the
  largest gap measured over seeds 0-5 of ``logits_against_reference``
  on the CPU: 5.47e-2 for zamba2-7b (logits up to about 2), 0.109 for
  rwkv6-1.6b (logits up to about 2.2).
* The reference's own contracts on the port alone: prefill then decode
  equals forward (``tests/test_models.py``'s), the hybrid's tail block,
  the chunk rule, a train step and (RWKV) the overfit check of
  ``tests/test_archs.py``.
* The loss and every gradient leaf against ``jax.value_and_grad``: loss
  within 1e-5 relative, each leaf within 1e-4 of its norm.
* The engine's tokens against the reference engine's under both
  policies, and the short-prompt caveat (ROADMAP, "Reference caveats"):
  a zamba2 prefill of fewer than ``conv_dim - 1`` tokens keeps a conv
  state of that many rows; the reference's engine serves a 1-token
  prompt by broadcasting its one row and raises on a 2-token prompt, and
  so does the port's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.streams import Policy as TPolicy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH = "zamba2-7b"
TOL = 5e-5
BF16_TOL = {"zamba2-7b": 8.2e-2, "rwkv6-1.6b": 0.164}
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
#: every leaf the reference's init sets to a constant
CONSTANT_LEAVES = {"ln1", "ln2", "ln", "final_norm", "norm", "conv_b",
                   "A_log", "dt_bias", "D_skip", "mu", "w_base", "u",
                   "ln_x"}
#: the smoke hybrid at 5 layers: 2 blocks of (shared attention + 2
#: mambas) and a tail of (shared attention + 1), tests/test_models.py's
#: test_zamba_tail_block
TAIL = {"num_layers": 5}


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.models import transformer
    return jax, jnp, registry, transformer


def cfgs(arch, dtype="float32", **kw):
    """(reference config, port config) of ``arch``'s smoke model."""
    _, _, reg, _ = _jax()
    kw = dict(kw, param_dtype=dtype, compute_dtype=dtype)
    return reg.smoke(arch).replace(**kw), treg.smoke(arch).replace(**kw)


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in CONSTANT_LEAVES:
            noise = 0.5 * rng.standard_normal(v.shape).astype(np.float32)
            out[k] = (np.asarray(v, np.float32) + noise).astype(v.dtype)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def params(ref_cfg, seed=0):
    """The reference's parameters (perturbed) on both sides, drawn once a
    module (the port's never written: a test that trains takes its own
    init)."""
    jax, jnp, _, T = _jax()
    host = jax.tree.map(np.asarray, T.init_params(ref_cfg,
                                                  jax.random.PRNGKey(seed)))
    host = _perturb(host, np.random.default_rng(seed + 100))
    return (jax.tree.map(jnp.asarray, host),
            carry.params_from_reference(host, device="cpu"))


def toks(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def gap(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


@functools.lru_cache(maxsize=None)
def _jitted(ref_cfg, max_len):
    jax, _, _, T = _jax()
    return (jax.jit(lambda p, b: T.forward(ref_cfg, p, b)),
            jax.jit(lambda p, t: T.prefill(ref_cfg, p, {"tokens": t},
                                           max_len=max_len)),
            jax.jit(lambda p, c, t: T.decode_step(ref_cfg, p, c, t)))


def logits_against_reference(arch, dtype="float32", seed=0, B=2, S=16,
                             Sp=12, **kw):
    """forward over ``S`` tokens, a prefill of ``Sp`` and teacher-forced
    decode steps to ``S`` on both sides: the max-abs gaps of the logits
    and of every cache leaf after each call, by name."""
    ref_cfg, cfg = cfgs(arch, dtype, **kw)
    ref_p, p = params(ref_cfg, seed)
    fwd, pre, dec = _jitted(ref_cfg, S)
    t = toks(cfg, B, S, seed)
    want, _ = fwd(ref_p, {"tokens": t})
    got, aux = tT.forward(cfg, p, {"tokens": t})
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(aux) == 0.0
    gaps = {"forward": gap(got, want)}
    want, rc = pre(ref_p, t[:, :Sp])
    got, cache = tT.prefill(cfg, p, {"tokens": t[:, :Sp]}, max_len=S)
    assert set(cache) == set(rc) and cache["pos"] == Sp

    def caches(tag):
        for name in rc:
            if name != "pos":
                assert tuple(cache[name].shape) == rc[name].shape, name
                assert cache[name].dtype == getattr(torch,
                                                    str(rc[name].dtype))
                gaps[f"{tag}/{name}"] = gap(cache[name], rc[name])

    gaps["prefill"] = gap(got, want)
    caches("prefill")
    for j in range(Sp, S):
        want, rc = dec(ref_p, rc, t[:, j:j + 1])
        got, cache = tT.decode_step(cfg, p, cache, t[:, j:j + 1])
        gaps[f"decode{j}"] = gap(got, want)
    caches("decode")
    assert cache["pos"] == int(rc["pos"]) == S
    return gaps


def port_consistency(cfg, seed=1, B=2, S=16, Sp=12):
    """tests/test_models.py's ``_consistency`` on the port alone: the
    prefill's and each decode step's logits against forward's."""
    p = tT.init_params(cfg, seed, device="cpu")
    t = toks(cfg, B, S)
    full, _ = tT.forward(cfg, p, {"tokens": t})
    lg, cache = tT.prefill(cfg, p, {"tokens": t[:, :Sp]}, max_len=S)
    errs = [gap(lg[:, 0], full[:, Sp - 1])]
    for j in range(Sp, S):
        lg, cache = tT.decode_step(cfg, p, cache, t[:, j:j + 1])
        errs.append(gap(lg[:, 0], full[:, j]))
    return errs


def loss_and_grads(arch, seed=0, B=2, S=24):
    """(loss, worst gradient leaf's ||dg|| / ||g||, its path) of the port
    against ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jax, _, _, T = _jax()
    ref_cfg, cfg = cfgs(arch)
    ref_p, p = params(ref_cfg, seed)
    t = toks(cfg, B, S, seed)
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        lambda q: T.loss_fn(ref_cfg, q, {"tokens": t}), has_aux=True))(ref_p)
    flat = jax.tree_util.tree_flatten_with_path(wgrads)[0]
    leaves = tadam.tree_leaves(p)
    assert len(leaves) == len(flat)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = tT.loss_fn(cfg, p, {"tokens": t})
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    worst = {}
    for (path, w), g in zip(flat, grads, strict=True):
        w, g = np.asarray(w, np.float32), g.float().numpy()
        worst[jax.tree_util.keystr(path)] = float(
            np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    name = max(worst, key=worst.get)
    return float(loss.detach()), float(want), worst[name], name


def smoke_train_step(arch):
    """tests/test_archs.py's test_smoke_train_step on the port."""
    cfg = treg.smoke(arch)
    opt_cfg = tadam.AdamWConfig(total_steps=10, warmup_steps=2,
                                schedule=cfg.schedule)
    p = tT.init_params(cfg, 0, device="cpu")
    opt = tadam.init_state(opt_cfg, p)
    batch = {"tokens": toks(cfg, 2, 32)}
    p, opt, m = tstep.train_step(cfg, opt_cfg, p, opt, batch)
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))
    assert int(opt.step) == 1
    for leaf in tadam.tree_leaves(p):
        assert bool(torch.isfinite(leaf).all())


def engines_agree(arch, policy, slots=3, max_len=24, n=4, prompt_len=6,
                  max_new=4):
    """The reference's engine and the port's, each on the same parameters
    and requests under ``policy``: equal tokens, stats and final pos.
    Returns the tokens."""
    from repro.core.streams import Policy
    from repro.serve.engine import Engine
    ref_cfg, cfg = cfgs(arch)
    ref_p, p = params(ref_cfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len) for _ in range(n)]
    ref = Engine(ref_cfg, ref_p, slots=slots, max_len=max_len,
                 policy=Policy(policy.value))
    ref_reqs = [ref.submit(q, max_new=max_new) for q in prompts]
    ref.run(max_steps=100)
    eng = TEngine(cfg, p, slots=slots, max_len=max_len, policy=policy,
                  device="cpu")
    reqs = [eng.submit(q, max_new=max_new) for q in prompts]
    eng.run(max_steps=100)
    assert all(r.done and len(r.out) == max_new for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert eng.stats == ref.stats
    assert eng.cache["pos"] == int(ref.cache["pos"])
    return [r.out for r in reqs]


def engine_on_prompt(arch, prompt_len, max_new=3, slots=2, max_len=16):
    """One request of ``prompt_len`` tokens through the reference's engine
    (jitted, at ``PRNGKey(0)``'s weights) and the port's: each side's
    tokens, or the exception it raised."""
    jax, _, reg, T = _jax()
    from repro.serve.engine import Engine
    ref_cfg, cfg = cfgs(arch)
    ref_p = T.init_params(ref_cfg, jax.random.PRNGKey(0))
    p = carry.params_from_reference(jax.tree.map(np.asarray, ref_p),
                                    device="cpu")
    prompt = np.arange(1, prompt_len + 1) % cfg.vocab_size
    out = []
    for eng in (Engine(ref_cfg, ref_p, slots=slots, max_len=max_len),
                TEngine(cfg, p, slots=slots, max_len=max_len, device="cpu")):
        r = eng.submit(prompt, max_new=max_new)
        try:
            eng.run(max_steps=20)
            out.append(r.out)
        except (ValueError, TypeError, RuntimeError) as e:
            out.append(e)
    return out


# ---- Mamba2 alone ---------------------------------------------------------
@pytest.mark.parametrize("S", [12, 24])
def test_mamba_full_matches_the_reference(S):
    """One mixer over S tokens: three chunks of 8 at S = 24, the whole
    sequence as one chunk at 12 (the reference's chunk rule), from a
    carried state; the output and both states within TOL."""
    import jax.numpy as jnp

    from repro.models import mamba2
    ref_cfg, cfg = cfgs(ARCH)
    ref_p, p = params(ref_cfg)
    lp = {k: v[0] for k, v in ref_p["layers"]["mamba"].items()}
    tp = {k: v[0] for k, v in p["layers"]["mamba"].items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    _, ssm_s = tmamba.state_shapes(cfg, 2)
    s0 = 0.3 * rng.standard_normal(ssm_s).astype(np.float32)
    c = cfg.ssm.chunk if S % cfg.ssm.chunk == 0 else S
    assert (c, S // c) == {12: (12, 1), 24: (8, 3)}[S]
    want, (wconv, wssm) = mamba2.mamba_full(ref_cfg, lp, jnp.asarray(x),
                                            jnp.asarray(s0))
    got, (conv, ssm) = tmamba.mamba_full(cfg, tp, torch.from_numpy(x),
                                         torch.from_numpy(s0))
    assert conv.shape == wconv.shape and ssm.shape == wssm.shape
    assert max(gap(got, want), gap(conv, wconv), gap(ssm, wssm)) <= TOL


def test_mamba_step_matches_the_reference():
    import jax.numpy as jnp

    from repro.models import mamba2
    ref_cfg, cfg = cfgs(ARCH)
    ref_p, p = params(ref_cfg)
    lp = {k: v[1] for k, v in ref_p["layers"]["mamba"].items()}
    tp = {k: v[1] for k, v in p["layers"]["mamba"].items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    conv_s, ssm_s = tmamba.state_shapes(cfg, 2)
    conv = rng.standard_normal(conv_s).astype(np.float32)
    ssm = 0.3 * rng.standard_normal(ssm_s).astype(np.float32)
    want = mamba2.mamba_step(ref_cfg, lp, jnp.asarray(x), jnp.asarray(conv),
                             jnp.asarray(ssm))
    got = tmamba.mamba_step(cfg, tp, torch.from_numpy(x),
                            torch.from_numpy(conv), torch.from_numpy(ssm))
    assert max(gap(g, w) for g, w in zip(got, want, strict=True)) <= TOL


def test_bfloat16_modules_give_the_reference_bits_run_eagerly():
    import jax.numpy as jnp

    from repro.models import mamba2
    ref_cfg, cfg = cfgs(ARCH, "bfloat16")
    ref_p, p = params(ref_cfg)
    lp = {k: v[0] for k, v in ref_p["layers"]["mamba"].items()}
    tp = {k: v[0] for k, v in p["layers"]["mamba"].items()}
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model))
    want, _ = mamba2.mamba_full(ref_cfg, lp, jnp.asarray(x, jnp.bfloat16))
    got, _ = tmamba.mamba_full(cfg, tp, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), _np(want))


# ---- the model ------------------------------------------------------------
def test_logits_and_caches_match_the_reference():
    gaps = logits_against_reference(ARCH)
    print(f"{ARCH}: max-abs gaps {gaps}")
    assert max(gaps.values()) <= TOL, gaps


def test_bfloat16_logits_match_the_reference():
    gaps = logits_against_reference(ARCH, "bfloat16")
    print(f"{ARCH} bfloat16: max-abs gaps {gaps}")
    assert max(gaps.values()) <= BF16_TOL[ARCH], gaps


def test_prefill_decode_consistency():
    """tests/test_models.py's test_prefill_decode_consistency[zamba2-7b]."""
    errs = port_consistency(treg.smoke(ARCH))
    assert max(errs) < TOL, errs


def test_zamba_tail_block():
    """81 = 13x6+3 layout: the tail block (attn + k<6 mambas) is
    exercised; 5 layers at attn_every 2 are 2 blocks and a tail."""
    cfg = treg.smoke(ARCH).replace(**TAIL)
    k, full, tail = tT.hybrid_blocks(cfg)
    assert (k, full, tail) == (2, 2, 1)
    assert tT.init_cache(cfg, 1, 8, device="cpu")["k"].shape[0] == 3
    errs = port_consistency(cfg)
    assert max(errs) < TOL, errs


def test_smoke_train_step():
    smoke_train_step(ARCH)


def test_loss_and_every_grad_leaf_match_the_reference():
    got, want, worst, name = loss_and_grads(ARCH)
    print(f"{ARCH}: loss {got} vs {want}; worst leaf {name} {worst}")
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    assert worst <= GRAD_RTOL, (name, worst)


def test_a_decay_sum_past_exps_range_keeps_the_gradient_finite():
    """The reference's caveat (ROADMAP, "Reference caveats"): with
    ``dt_bias`` at 20, a chunk's exponent above the diagonal passes
    float32's 88.7, and ``jax.grad`` gives NaN through every leaf the
    mixers reach.  The port's loss is the reference's, its gradient
    finite, and the leaves after the mixers (the final norm, the head)
    equal the reference's."""
    jax, jnp, _, T = _jax()
    ref_cfg, cfg = cfgs(ARCH)
    host = jax.tree.map(np.asarray, params(ref_cfg)[0])
    host["layers"]["mamba"]["dt_bias"] = \
        host["layers"]["mamba"]["dt_bias"] + np.float32(20.0)
    ref_p = jax.tree.map(jnp.asarray, host)
    p = carry.params_from_reference(host, device="cpu")
    t = toks(cfg, 2, 16, 9)
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        lambda q: T.loss_fn(ref_cfg, q, {"tokens": t}), has_aux=True))(ref_p)
    for x in tadam.tree_leaves(p):
        x.requires_grad_(True)
    loss, _ = tT.loss_fn(cfg, p, {"tokens": t})
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= LOSS_RTOL * abs(
        float(want))
    assert np.isnan(np.asarray(wgrads["layers"]["mamba"]["in_proj"])).any()
    assert all(bool(torch.isfinite(x.grad).all())
               for x in tadam.tree_leaves(p))
    for got, w in ((p["final_norm"].grad, wgrads["final_norm"]),
                   (p["lm_head"].grad, wgrads["lm_head"])):
        w = np.asarray(w, np.float32)
        assert np.linalg.norm(got.numpy() - w) <= GRAD_RTOL * np.linalg.norm(w)


def test_remat_full_recomputes_each_layer_and_shared_attention_once():
    """Under remat full the backward reruns every mamba layer's two
    RMSNorms and each shared attention's norm and flash once; the head's
    norm runs once: rmsnorm 2(2L + A) + 1, flash 2A."""
    from repro_torch.kernels import ops
    cfg = treg.smoke(ARCH).replace(remat="full", **TAIL)
    L, A = cfg.num_layers, 3
    p = tT.init_params(cfg, 6, device="cpu")
    for x in tadam.tree_leaves(p):
        x.requires_grad_(True)
    calls = {"rmsnorm": 0, "flash_attention": 0}
    real = {n: getattr(ops, n) for n in calls}

    def count(n):
        def fn(*a, **k):
            calls[n] += 1
            return real[n](*a, **k)
        return fn

    try:
        for n in calls:
            setattr(ops, n, count(n))
        loss, _ = tT.loss_fn(cfg, p, {"tokens": toks(cfg, 2, 16)})
        assert calls == {"rmsnorm": 2 * L + A + 1, "flash_attention": A}
        loss.backward()
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)
    assert calls == {"rmsnorm": 2 * (2 * L + A) + 1, "flash_attention": 2 * A}


@pytest.mark.parametrize("arch", [ARCH, "rwkv6-1.6b"])
def test_remat_policies_give_the_same_loss_and_grads(arch):
    """remat full and dots against none: the shared attention, whose
    parameters its checkpoint reaches as a closure, gets its gradient."""
    cfg = treg.smoke(arch).replace(**(TAIL if arch == ARCH else {}))
    p = tT.init_params(cfg, 8, device="cpu")
    leaves = tadam.tree_leaves(p)
    t = {"tokens": toks(cfg, 2, 16, 8)}
    runs = {}
    for remat in ("none", "full", "dots"):
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = tT.loss_fn(cfg.replace(remat=remat), p, t)
        runs[remat] = (float(loss.detach()),
                       torch.autograd.grad(loss, leaves))
        for x in leaves:
            x.requires_grad_(False)
    loss0, g0 = runs["none"]
    assert all(float(g.abs().max()) > 0 for g in g0)
    for remat in ("full", "dots"):
        loss, g = runs[remat]
        assert loss == loss0, remat
        for a, b in zip(g, g0, strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)


# ---- the engine -----------------------------------------------------------
@pytest.mark.parametrize("policy", [TPolicy.HAZARD_ONLY, TPolicy.SYNC_ALWAYS])
def test_engine_tokens_equal_the_reference_engines(policy):
    engines_agree(ARCH, policy)


def test_a_short_prompt_keeps_its_rows_and_the_step_then_raises():
    """A prefill of S < conv_dim - 1 tokens keeps S conv rows on both
    sides; the next decode step raises on both."""
    jax, jnp, _, T = _jax()
    ref_cfg, cfg = cfgs(ARCH)
    ref_p, p = params(ref_cfg)
    t = toks(cfg, 1, 2, 7)
    _, rc = T.prefill(ref_cfg, ref_p, {"tokens": t}, max_len=8)
    _, cache = tT.prefill(cfg, p, {"tokens": t}, max_len=8)
    assert rc["conv"].shape[2] == cache["conv"].shape[2] == 2
    assert gap(cache["conv"], rc["conv"]) <= TOL
    with pytest.raises((ValueError, TypeError)):
        T.decode_step(ref_cfg, ref_p, rc, jnp.asarray(t[:, :1]))
    with pytest.raises(RuntimeError, match="einsum"):
        tT.decode_step(cfg, p, cache, t[:, :1])


def test_engine_serves_a_one_token_prompt_and_refuses_two():
    """The reference's splice broadcasts a 1-token prompt's one conv row
    into all three and refuses a 2-token prompt's two; so does the
    port's."""
    ref, port = engine_on_prompt(ARCH, 1)
    print(f"{ARCH}: a 1-token prompt served {ref} / {port}")
    assert isinstance(port, list) and ref == port
    ref, port = engine_on_prompt(ARCH, 2)
    assert isinstance(ref, (ValueError, TypeError)), ref
    assert isinstance(port, RuntimeError), port
    assert "(3) must match the existing size (2)" in str(port)


def test_serve_lm_command_serves_the_smoke_model(capsys):
    stats = tserve.main(["--lm", "--arch", ARCH, "--device", "cpu"])
    assert "served 8 requests, 96 tokens" in capsys.readouterr().out
    # two waves of 4 slots, 11 decode steps each after the prefill's token
    assert stats == {"launches": 8 + 22, "syncs": 8 + 22, "steps": 22}
