"""The port's AdamW and train step against the reference's, on the CPU.

Three ``train_step`` s (AdamW, cosine schedule) from the reference's
parameters on both sides: the loss, grad norm and lr of each step, and
the parameters and both moments after the last, each leaf within 1e-5 of
its norm.  ``lr_at`` for all four schedules within 1e-7; microbatches 2
against 1 (``tests/test_archs.py``'s tolerances) and against the
reference's own microbatched step; the reference's contracts
``test_smoke_train_step`` on the dense archs and the four ported since
(experts, codebooks, a patch prefix), ``test_overfit_tiny_batch``,
``test_wsd_schedule_shape`` and
``test_padding_dummy_heads_stay_zero_after_training``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_lm_models import _batch, _params, _toks  # noqa: E402

STATE_RTOL = 1e-5
LR_TOL = 1e-7
SCHEDULES = ["cosine", "wsd", "linear", "constant"]
DENSE = ["qwen2-0.5b", "granite-3-2b", "minicpm-2b", "qwen2.5-32b",
         "cupbop-demo-120m"]
#: the families ported since (experts, codebooks, a patch prefix)
LATER = ["grok-1-314b", "deepseek-moe-16b", "musicgen-medium",
         "internvl2-76b"]


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.optim import adamw
    from repro.train import step
    return jax, jnp, registry, adamw, step


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _run_reference(cfg, opt_cfg, host_p, batch, steps, microbatches=1):
    jax, jnp, _, adamw, step = _jax()
    p = jax.tree.map(jnp.asarray, host_p)
    o = adamw.init_state(opt_cfg, p)
    fn = jax.jit(step.make_train_step(cfg, opt_cfg,
                                      microbatches=microbatches))
    metrics = []
    for _ in range(steps):
        p, o, m = fn(p, o, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return p, o, metrics


def _run_port(cfg, opt_cfg, p, batch, steps, microbatches=1):
    o = tadam.init_state(opt_cfg, p)
    fn = tstep.make_train_step(cfg, opt_cfg, microbatches=microbatches)
    metrics = []
    for _ in range(steps):
        p, o, m = fn(p, o, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return p, o, metrics


@pytest.fixture(scope="module")
def three_steps():
    """Three cosine AdamW steps of granite-3-2b's smoke model on both
    sides from the reference's parameters."""
    jax, _, reg, adamw, _ = _jax()
    ref_cfg, cfg = reg.smoke("granite-3-2b"), treg.smoke("granite-3-2b")
    kw = dict(total_steps=10, warmup_steps=2, schedule="cosine")
    ref_p, p = _params(ref_cfg, 4)
    host = jax.tree.map(np.asarray, ref_p)
    batch = {"tokens": _toks(cfg, 4, 16, seed=4)}
    want = _run_reference(ref_cfg, adamw.AdamWConfig(**kw), host, batch, 3)
    got = _run_port(cfg, tadam.AdamWConfig(**kw), p, batch, 3)
    return want, got


def test_three_adamw_steps_match_the_reference_metrics(three_steps):
    (_, _, want), (_, _, got) = three_steps
    for w, g in zip(want, got, strict=True):
        assert set(g) == set(w) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= STATE_RTOL * abs(w[k]), (k, g, w)
        assert abs(g["lr"] - w["lr"]) <= LR_TOL


@pytest.mark.parametrize("what", ["params", "m", "v"])
def test_three_adamw_steps_match_the_reference_state(three_steps, what):
    jax = _jax()[0]
    (wp, wo, _), (gp, go, _) = three_steps
    assert int(go.step) == int(wo.step) == 3
    want = {"params": wp, "m": wo.m, "v": wo.v}[what]
    got = {"params": gp, "m": go.m, "v": go.v}[what]
    wl, gl = jax.tree.leaves(want), tadam.tree_leaves(got)
    assert len(wl) == len(gl)
    worst = max(_rel(g.float().numpy(), w)
                for w, g in zip(wl, gl, strict=True))
    assert worst <= STATE_RTOL, worst


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_lr_at_matches_the_reference(schedule):
    _, jnp, _, adamw, _ = _jax()
    kw = dict(lr_peak=3e-3, schedule=schedule, warmup_steps=10,
              total_steps=100, decay_frac=0.2, lr_min_ratio=0.1)
    rc, tc = adamw.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    for s in range(0, 111):
        want = float(adamw.lr_at(rc, jnp.int32(s)))
        got = tadam.lr_at(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= LR_TOL, s
        assert abs(float(tadam.lr_at(tc, s)) - float(adamw.lr_at(rc, s))
                   ) <= LR_TOL, s


def test_wsd_schedule_shape():
    cfg = tadam.AdamWConfig(lr_peak=1.0, schedule="wsd", warmup_steps=10,
                            total_steps=100, decay_frac=0.2,
                            lr_min_ratio=0.1)
    lrs = [float(tadam.lr_at(cfg, s)) for s in range(101)]
    assert lrs[5] < lrs[10]                       # warmup
    assert abs(lrs[40] - 1.0) < 1e-6              # stable plateau
    assert abs(lrs[79] - 1.0) < 1e-6              # still stable at 80%
    assert lrs[90] < 0.7                          # decaying
    assert abs(lrs[100] - 0.1) < 1e-2             # floor


def test_apply_updates_decays_matrices_only_and_keeps_state_dtype():
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    cfg = tadam.AdamWConfig(lr_peak=0.5, warmup_steps=0, schedule="constant",
                            weight_decay=0.1, state_dtype="bfloat16")
    st = tadam.init_state(cfg, p)
    new, st, m = tadam.apply_updates(cfg, p, g, st)
    assert torch.equal(new["b"], p["b"])                 # no decay
    assert torch.allclose(new["w"], torch.full((3, 2), 1 - 0.5 * 0.1))
    assert st.m["w"].dtype == torch.bfloat16 and int(st.step) == 1
    assert float(m["grad_norm"]) == 0.0


def test_microbatches_match_the_full_batch_and_the_reference():
    """tests/test_archs.py::test_microbatch_accumulation_matches_full_batch
    on the port, and the port's microbatched step against the
    reference's."""
    jax, _, reg, adamw, _ = _jax()
    ref_cfg, cfg = reg.smoke("granite-3-2b"), treg.smoke("granite-3-2b")
    kw = dict(total_steps=10, warmup_steps=1)
    ref_p, p = _params(ref_cfg, 6)
    host = jax.tree.map(np.asarray, ref_p)
    batch = {"tokens": _toks(cfg, 4, 16, seed=6)}
    p1, _, m1 = _run_port(cfg, tadam.AdamWConfig(**kw), p, batch, 1)
    p2, _, m2 = _run_port(cfg, tadam.AdamWConfig(**kw), p, batch, 1,
                          microbatches=2)
    np.testing.assert_allclose(m1[0]["loss"], m2[0]["loss"], rtol=1e-5)
    assert set(m2[0]) == {"loss", "grad_norm", "lr"}
    for a, b in zip(tadam.tree_leaves(p1), tadam.tree_leaves(p2),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    wp, _, wm = _run_reference(ref_cfg, adamw.AdamWConfig(**kw), host, batch,
                               1, microbatches=2)
    assert abs(m2[0]["loss"] - wm[0]["loss"]) <= STATE_RTOL * wm[0]["loss"]
    worst = max(_rel(g.numpy(), w) for w, g in
                zip(jax.tree.leaves(wp), tadam.tree_leaves(p2),
                    strict=True))
    assert worst <= STATE_RTOL, worst


@pytest.mark.parametrize("arch", DENSE + LATER)
def test_smoke_train_step(arch):
    cfg = treg.smoke(arch)
    opt_cfg = tadam.AdamWConfig(total_steps=10, warmup_steps=2,
                                schedule=cfg.schedule)
    params = tT.init_params(cfg, 0, device="cpu")
    opt = tadam.init_state(opt_cfg, params)
    batch = _batch(cfg, 2, 32)
    params, opt, m = tstep.train_step(cfg, opt_cfg, params, opt, batch)
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))
    assert int(opt.step) == 1
    for leaf in tadam.tree_leaves(params):
        assert bool(torch.isfinite(leaf).all())
    ev = tstep.eval_step(cfg, params, batch)
    assert np.isfinite(float(ev["loss"])) and not ev["loss"].requires_grad


def test_overfit_tiny_batch():
    """Loss strictly decreases on a repeated batch (training works)."""
    cfg = treg.smoke("qwen2-0.5b")
    opt_cfg = tadam.AdamWConfig(lr_peak=1e-3, total_steps=30, warmup_steps=1)
    params = tT.init_params(cfg, 0, device="cpu")
    opt = tadam.init_state(opt_cfg, params)
    step = tstep.make_train_step(cfg, opt_cfg)
    batch = {"tokens": _toks(cfg, 2, 16)}
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


def test_padding_dummy_heads_stay_zero_after_training():
    """Dummy-head gradients vanish: wq's padding slots stay exactly zero."""
    cfg = treg.smoke("qwen2-0.5b").replace(
        num_heads=3, num_kv_heads=1, head_dim=16, tp_align=4)
    plan = tattn.plan_for(cfg)
    assert not plan.is_identity
    params = tT.init_params(cfg, 0, device="cpu")
    opt_cfg = tadam.AdamWConfig(lr_peak=1e-2, total_steps=5, warmup_steps=1,
                                weight_decay=0.0)
    opt = tadam.init_state(opt_cfg, params)
    step = tstep.make_train_step(cfg, opt_cfg)
    batch = {"tokens": _toks(cfg, 2, 16)}
    for _ in range(3):
        params, opt, _ = step(params, opt, batch)
    hd = cfg.hd
    wq = params["layers"]["attn"]["wq"].reshape(
        cfg.num_layers, cfg.d_model, plan.hq_p, hd)
    dummy = [j for j, src in enumerate(plan.qmap) if src < 0]
    assert dummy
    for j in dummy:
        assert not wq[:, :, j].any(), f"dummy q head {j} trained"
