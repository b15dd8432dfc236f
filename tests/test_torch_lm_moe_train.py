"""The port's training path on the mixture-of-experts decoder against the
reference's, on the CPU.

deepseek-moe-16b's smoke model (shared and routed experts) from the
reference's parameters: the loss, its ``ce`` and ``aux`` terms and every
gradient leaf under both dispatch modes (the loss within 1e-5 relative,
aux within 1e-5, each leaf within 1e-4 of its norm; the router's and
experts' gradients flow through the top-k weights, not the indices, as
``jax.grad``'s); three cosine AdamW steps (metrics and the parameters
and both moments after the last, each leaf within 1e-5 of its norm); a
checkpoint of the nested ``moe`` leaves that resumes bit for bit; remat
``none``, ``full`` and ``dots`` alike; and the reference's
``test_overfit_tiny_batch`` for this arch.  Each reference result is
computed once per module.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_lm_models import _params, _toks  # noqa: E402
from test_torch_lm_moe import _cfgs  # noqa: E402

ARCH = "deepseek-moe-16b"
LOSS_RTOL = 1e-5
AUX_TOL = 1e-5
GRAD_RTOL = 1e-4
STATE_RTOL = 1e-5


def _jax():
    import jax

    from repro.models import transformer
    from repro.optim import adamw
    from repro.train import step
    return jax, transformer, adamw, step


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_grads(cfg, p, batch):
    (loss, metrics), grads = tstep.value_and_grad(
        tstep.make_loss(cfg), p, batch)
    return loss, metrics, tadam.tree_leaves(grads)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_loss_aux_and_every_grad_leaf_match_the_reference(dispatch):
    jax, T, _, _ = _jax()
    rc, cfg = _cfgs(ARCH, dispatch=dispatch)
    ref_p, p = _params(rc, 1)
    batch = {"tokens": _toks(cfg, 2, 24, seed=1)}
    (want, wm), wgrads = jax.jit(jax.value_and_grad(
        lambda q: T.loss_fn(rc, q, batch), has_aux=True))(ref_p)
    loss, metrics, grads = _port_grads(cfg, p, batch)
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert abs(float(metrics["aux"]) - float(wm["aux"])) <= AUX_TOL
    assert abs(float(metrics["ce"]) - float(wm["ce"])) <= \
        LOSS_RTOL * abs(float(wm["ce"]))
    flat = jax.tree_util.tree_flatten_with_path(wgrads)[0]
    assert len(flat) == len(grads)
    worst = {jax.tree_util.keystr(k): _rel(g.float().numpy(), w)
             for (k, w), g in zip(flat, grads, strict=True)}
    print(f"{dispatch}: loss {float(loss)} vs {float(want)}, aux "
          f"{float(metrics['aux'])}; worst leaf {max(worst, key=worst.get)} "
          f"{max(worst.values())}")
    assert max(worst.values()) <= GRAD_RTOL, worst
    names = [jax.tree_util.keystr(k) for k, _ in flat]
    for leaf in ("router", "w_gate", "w_down", "shared"):
        i = next(j for j, n in enumerate(names) if leaf in n)
        assert float(grads[i].abs().max()) > 0, names[i]


@pytest.fixture(scope="module")
def three_steps():
    """Three cosine AdamW steps of the deepseek smoke model on both sides
    from the reference's parameters."""
    jax, _, adamw, step = _jax()
    rc, cfg = _cfgs(ARCH)
    kw = dict(total_steps=10, warmup_steps=2, schedule="cosine")
    ref_p, p = _params(rc, 4)
    batch = {"tokens": _toks(cfg, 4, 16, seed=4)}
    fn = jax.jit(step.make_train_step(rc, adamw.AdamWConfig(**kw)))
    wp, wo, want = ref_p, adamw.init_state(adamw.AdamWConfig(**kw), ref_p), []
    for _ in range(3):
        wp, wo, m = fn(wp, wo, batch)
        want.append({k: float(v) for k, v in m.items()})
    tcfg = tadam.AdamWConfig(**kw)
    gp, go, got = p, tadam.init_state(tcfg, p), []
    for _ in range(3):
        gp, go, m = tstep.train_step(cfg, tcfg, gp, go, batch)
        got.append({k: float(v) for k, v in m.items()})
    return (wp, wo, want), (gp, go, got)


def test_three_adamw_steps_match_the_reference(three_steps):
    jax = _jax()[0]
    (wp, wo, want), (gp, go, got) = three_steps
    for w, g in zip(want, got, strict=True):
        assert set(g) == set(w) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in ("loss", "ce", "grad_norm"):
            assert abs(g[k] - w[k]) <= STATE_RTOL * abs(w[k]), (k, g, w)
        assert abs(g["aux"] - w["aux"]) <= AUX_TOL
    assert int(go.step) == int(wo.step) == 3
    for what, (w, g) in {"params": (wp, gp), "m": (wo.m, go.m),
                         "v": (wo.v, go.v)}.items():
        wl, gl = jax.tree.leaves(w), tadam.tree_leaves(g)
        assert len(wl) == len(gl)
        worst = max(_rel(a.float().numpy(), b)
                    for b, a in zip(wl, gl, strict=True))
        assert worst <= STATE_RTOL, (what, worst)


def test_a_checkpoint_of_the_experts_resumes_bit_for_bit(tmp_path):
    """Two steps straight, against one step, a save and restore of the
    nested ``moe`` leaves into other parameters, and the second step."""
    cfg = treg.smoke(ARCH)
    opt_cfg = tadam.AdamWConfig(total_steps=10, warmup_steps=1)
    b0, b1 = ({"tokens": _toks(cfg, 2, 16, seed=s)} for s in (0, 1))
    p = tT.init_params(cfg, 0, device="cpu")
    p, o, _ = tstep.train_step(cfg, opt_cfg, p, tadam.init_state(opt_cfg, p),
                               b0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (p, o), extra={"data_step": 1}, blocking=True)
    want_p, want_o, want_m = tstep.train_step(cfg, opt_cfg, p, o, b1)
    q = tT.init_params(cfg, 5, device="cpu")
    (q, qo), extra = mgr.restore((q, tadam.init_state(opt_cfg, q)))
    assert extra == {"data_step": 1} and int(qo.step) == 1
    got_p, got_o, got_m = tstep.train_step(cfg, opt_cfg, q, qo, b1)
    assert float(got_m["loss"]) == float(want_m["loss"])
    for got, want in ((got_p, want_p), (got_o.m, want_o.m),
                      (got_o.v, want_o.v)):
        for a, b in zip(tadam.tree_leaves(got), tadam.tree_leaves(want),
                        strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        names = json.load(f)["leaves"]
    assert {"0_layers_moe_router", "0_layers_moe_experts_w_gate",
            "0_layers_moe_shared_w_down",
            "1_.m_layers_moe_experts_w_up"} <= set(names)


def test_remat_policies_give_the_same_loss_and_grads():
    cfg = treg.smoke(ARCH)
    p = tT.init_params(cfg, 3, device="cpu")
    batch = {"tokens": _toks(cfg, 2, 16, seed=3)}
    runs = {remat: _port_grads(cfg.replace(remat=remat), p, batch)
            for remat in ("none", "full", "dots")}
    loss0, m0, g0 = runs["none"]
    for remat in ("full", "dots"):
        loss, m, g = runs[remat]
        assert float(loss) == float(loss0), remat
        assert float(m["aux"]) == float(m0["aux"]), remat
        for a, b in zip(g, g0, strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_overfit_tiny_batch():
    """The reference's contract for this arch: the loss falls by more
    than 0.05 over 8 steps on a repeated batch."""
    cfg = treg.smoke(ARCH)
    opt_cfg = tadam.AdamWConfig(lr_peak=1e-3, total_steps=30, warmup_steps=1)
    params = tT.init_params(cfg, 0, device="cpu")
    opt = tadam.init_state(opt_cfg, params)
    step = tstep.make_train_step(cfg, opt_cfg)
    batch = {"tokens": _toks(cfg, 2, 16)}
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["aux"]))
    assert losses[-1] < losses[0] - 0.05, losses
