"""The port's RWKV6 model (rwkv6-1.6b's smoke config) against the
reference's, on the CPU: the time mix, the channel mix and the decode
recurrence alone, then the model's logits and caches, its loss and
gradients, the reference's contracts on the port (prefill then decode
equals forward, a train step, the overfit check) and the engine.  The
helpers, the parameters and the tolerances are
``tests/test_torch_lm_ssm.py``'s, whose docstring says how each was set.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.streams import Policy as TPolicy  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_lm_ssm import (BF16_TOL, GRAD_RTOL, LOSS_RTOL, TOL,  # noqa: E402
                               _jax, cfgs, engine_on_prompt, engines_agree,
                               gap, logits_against_reference,
                               loss_and_grads, params, port_consistency,
                               smoke_train_step, toks)

ARCH = "rwkv6-1.6b"


def _layer(ref_p, p, i=0):
    return ({k: v[i] for k, v in ref_p["layers"]["rwkv"].items()},
            {k: v[i] for k, v in p["layers"]["rwkv"].items()})


def _inputs(cfg, S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    H, hd = trwkv.rdims(cfg)
    state = 0.3 * rng.standard_normal((2, H, hd, hd)).astype(np.float32)
    return x, last, state


# ---- the mixers alone -----------------------------------------------------
@pytest.mark.parametrize("S", [12, 24])
def test_time_and_channel_mix_match_the_reference(S):
    """Over S tokens from a carried state and last token: three chunks of
    8 at S = 24, the whole sequence at 12; the outputs, the state and the
    last tokens within TOL."""
    import jax.numpy as jnp

    from repro.models import rwkv6
    ref_cfg, cfg = cfgs(ARCH)
    lp, tp = _layer(*params(ref_cfg))
    x, last, state = _inputs(cfg, S, S)
    want, (ws, wl) = rwkv6.time_mix_full(ref_cfg, lp, jnp.asarray(x),
                                         jnp.asarray(state),
                                         jnp.asarray(last))
    got, (gs, gl) = trwkv.time_mix_full(cfg, tp, torch.from_numpy(x),
                                        torch.from_numpy(state),
                                        torch.from_numpy(last))
    gaps = [gap(got, want), gap(gs, ws), gap(gl, wl)]
    want, wl = rwkv6.channel_mix(ref_cfg, lp, jnp.asarray(x),
                                 jnp.asarray(last))
    got, gl = trwkv.channel_mix(cfg, tp, torch.from_numpy(x),
                                torch.from_numpy(last))
    gaps += [gap(got, want), gap(gl, wl)]
    assert max(gaps) <= TOL, gaps


def test_time_mix_step_matches_the_reference():
    import jax.numpy as jnp

    from repro.models import rwkv6
    ref_cfg, cfg = cfgs(ARCH)
    lp, tp = _layer(*params(ref_cfg), 1)
    x, last, state = _inputs(cfg, 1, 4)
    want = rwkv6.time_mix_step(ref_cfg, lp, jnp.asarray(x),
                               jnp.asarray(state), jnp.asarray(last))
    got = trwkv.time_mix_step(cfg, tp, torch.from_numpy(x),
                              torch.from_numpy(state), torch.from_numpy(last))
    assert max(gap(g, w) for g, w in zip(got, want, strict=True)) <= TOL


def test_the_chunked_form_equals_the_recurrence():
    """tests/test_models.py's chunked == recurrent on the port: the time
    mix over 16 tokens (two chunks) against 16 decode steps."""
    _, cfg = cfgs(ARCH)
    _, tp = _layer(*params(cfgs(ARCH)[0]))
    x = torch.from_numpy(_inputs(cfg, 16, 9)[0])
    full, (state, _) = trwkv.time_mix_full(cfg, tp, x)
    H, hd = trwkv.rdims(cfg)
    s = torch.zeros(2, H, hd, hd)
    last = torch.zeros(2, 1, cfg.d_model)
    steps = []
    for t in range(16):
        y, s, last = trwkv.time_mix_step(cfg, tp, x[:, t:t + 1], s, last)
        steps.append(y)
    assert gap(torch.cat(steps, 1), full) <= TOL
    assert gap(s, state) <= TOL


def test_bfloat16_modules_run_eagerly_land_within_one_step_of_the_reference():
    """In bfloat16 the mixers run eagerly on both sides give the
    reference's values or a neighbouring bfloat16 value: the float32
    ``exp`` and ``tanh`` of the two libraries may part in the last bit,
    and the rounding to bfloat16 then lands on the other side."""
    import jax.numpy as jnp

    from repro.models import rwkv6
    ref_cfg, cfg = cfgs(ARCH, "bfloat16")
    lp, tp = _layer(*params(ref_cfg))
    x = _inputs(cfg, 16, 5)[0]
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    for want, got in ((rwkv6.time_mix_full(ref_cfg, lp, xj)[0],
                       trwkv.time_mix_full(cfg, tp, xt)[0]),
                      (rwkv6.channel_mix(ref_cfg, lp, xj)[0],
                       trwkv.channel_mix(cfg, tp, xt)[0])):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                       - 7)
        assert (np.abs(got.float().numpy() - want) <= step).all()


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
    """tests/test_models.py's test_prefill_decode_consistency[rwkv6-1.6b]."""
    errs = port_consistency(treg.smoke(ARCH))
    assert max(errs) < TOL, errs


def test_smoke_train_step():
    smoke_train_step(ARCH)


def test_overfit_tiny_batch():
    """tests/test_archs.py's test_overfit_tiny_batch[rwkv6-1.6b]: the loss
    strictly decreases on a repeated batch."""
    cfg = treg.smoke(ARCH)
    opt_cfg = tadam.AdamWConfig(lr_peak=1e-3, total_steps=30, warmup_steps=1)
    p = tT.init_params(cfg, 0, device="cpu")
    opt = tadam.init_state(opt_cfg, p)
    step = tstep.make_train_step(cfg, opt_cfg)
    batch = {"tokens": toks(cfg, 2, 16)}
    losses = []
    for _ in range(8):
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


def test_loss_and_every_grad_leaf_match_the_reference():
    got, want, worst, name = loss_and_grads(ARCH)
    print(f"{ARCH}: loss {got} vs {want}; worst leaf {name} {worst}")
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    assert worst <= GRAD_RTOL, (name, worst)


# ---- the engine -----------------------------------------------------------
@pytest.mark.parametrize("policy", [TPolicy.HAZARD_ONLY, TPolicy.SYNC_ALWAYS])
def test_engine_tokens_equal_the_reference_engines(policy):
    engines_agree(ARCH, policy)


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_short_prompts_prefill_and_decode_as_the_reference(S):
    """RWKV keeps no conv window: prompts of 1, 2, 3 and 5 tokens prefill
    and decode on both sides, within TOL, and the engine serves them."""
    jax, jnp, _, T = _jax()
    ref_cfg, cfg = cfgs(ARCH)
    ref_p, p = params(ref_cfg)
    t = toks(cfg, 1, S + 1, S)
    want, rc = T.prefill(ref_cfg, ref_p, {"tokens": t[:, :S]}, max_len=8)
    got, cache = tT.prefill(cfg, p, {"tokens": t[:, :S]}, max_len=8)
    gaps = [gap(got, want)]
    want, _ = T.decode_step(ref_cfg, ref_p, rc, jnp.asarray(t[:, S:]))
    got, _ = tT.decode_step(cfg, p, cache, t[:, S:])
    gaps.append(gap(got, want))
    assert max(gaps) <= TOL, gaps
    if S <= 2:
        ref, port = engine_on_prompt(ARCH, S)
        assert isinstance(port, list) and ref == port
