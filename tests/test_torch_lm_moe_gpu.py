"""The mixture-of-experts, audio and VLM paths on the card: each call
launches the hand-written kernels, and only them, the sort dispatch gives
the same bits twice, and the kernels' logits hold their plain versions'.

Marked ``gpu``; each test skips without a card.  No JAX here: the plain
versions (``mode="interpret"``) on the card are the yardstick.  Run with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_moe_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import lower_cuda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import step as train_mod  # noqa: E402

#: float32 kernels and plain versions differ by the order of their sums
#: (tests/test_torch_lm_gpu.py's 5e-5); no gate is near a tie at that size
F32_TOL = 5e-5
ARCHS = ["deepseek-moe-16b", "grok-1-314b", "musicgen-medium",
         "internvl2-76b"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(arch, dtype="bfloat16", **moe_kw):
    cfg = registry.smoke(arch).replace(param_dtype=dtype,
                                       compute_dtype=dtype)
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg


def _counts():
    kernels = {**ops.KERNELS, **lower_cuda.KERNELS}
    return {n: k.launches for n, k in kernels.items() if k.launches}


def _zero():
    for k in (*ops.KERNELS.values(), *lower_cuda.KERNELS.values()):
        k.launches = 0


def _flash_kernel(cfg, B, Sq, Skv, dev):
    plan = attention.plan_for(cfg)
    q = torch.empty(B, plan.hq_p, Sq, cfg.hd, dtype=cfg.cdtype, device=dev)
    kv = torch.empty(B, plan.hkv_p, Skv, cfg.hd, dtype=cfg.cdtype,
                     device=dev)
    return ops.ROUTES["flash_attention"][tfa.route(q, kv, kv)]


def _batch(cfg, B, S, dev, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape)).to(dev)}
    if cfg.patch_prefix:
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.patch_prefix, cfg.d_model)).astype(np.float32)
            * 0.02).to(dev)
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_launch_the_kernels_of_their_path(card, arch):
    """A prefill and a decode step each launch rmsnorm 2L + 1 times and
    their routed flash kernel L times, and no other kernel."""
    cfg = _cfg(arch)
    L, P = cfg.num_layers, cfg.patch_prefix
    params = T.init_params(cfg, 0)
    batch = _batch(cfg, 2, 12, card)
    _zero()
    _, cache = T.prefill(cfg, params, batch, max_len=16 + P)
    torch.cuda.synchronize()
    assert _counts() == {"rmsnorm": 2 * L + 1,
                         _flash_kernel(cfg, 2, 12 + P, 12 + P, card): L}
    _zero()
    T.decode_step(cfg, params, cache, batch["tokens"][:, :1])
    torch.cuda.synchronize()
    assert _counts() == {"rmsnorm": 2 * L + 1, "flash_decode": L}


@pytest.mark.gpu
def test_engine_serves_the_experts_through_the_kernels(card):
    cfg = _cfg("deepseek-moe-16b")
    L = cfg.num_layers
    eng = Engine(cfg, T.init_params(cfg, 0), slots=3, max_len=48)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, 8), max_new=6)
            for _ in range(5)]
    _zero()
    eng.run(max_steps=200)
    torch.cuda.synchronize()
    assert all(r.done and len(r.out) == 6 for r in reqs)
    prefills, steps = 5, eng.stats["steps"]
    assert eng.stats["launches"] == prefills + steps
    want = {"rmsnorm": (2 * L + 1) * (prefills + steps),
            "flash_decode": L * steps}
    pre = _flash_kernel(cfg, 1, 8, 8, card)
    want[pre] = want.get(pre, 0) + L * prefills
    assert _counts() == want


@pytest.mark.gpu
def test_sort_dispatch_gives_the_same_bits_twice(card):
    """The sort path's scatters have a fixed order on the card."""
    cfg = _cfg("deepseek-moe-16b", dispatch="sort")
    params = T.init_params(cfg, 1)
    batch = _batch(cfg, 2, 64, card, seed=1)
    a, ca = T.prefill(cfg, params, batch, max_len=64)
    b, cb = T.prefill(cfg, params, batch, max_len=64)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
    full = [T.forward(cfg, params, batch)[0] for _ in range(2)]
    assert torch.equal(full[0], full[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_float32_logits_and_routing_hold_the_plain_versions(card, dispatch):
    """Kernels against plain versions on the same parameters in float32:
    every token routed to the same experts, logits within F32_TOL."""
    cfg = _cfg("deepseek-moe-16b", "float32", dispatch=dispatch)
    params = T.init_params(cfg, 2)
    batch = _batch(cfg, 2, 24, card, seed=2)
    routes = []
    real = moe._route

    def record(c, p, xt):
        out = real(c, p, xt)
        routes.append(out[1].sort(-1).values)
        return out
    moe._route = record
    try:
        got, aux = T.forward(cfg, params, batch)
        n = len(routes)
        want, waux = T.forward(cfg, params, batch, mode="interpret")
    finally:
        moe._route = real
    assert n == cfg.num_layers
    for a, b in zip(routes[:n], routes[n:], strict=True):
        assert torch.equal(a, b)
    assert float((got - want).abs().max()) <= F32_TOL
    assert abs(float(aux) - float(waux)) <= F32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "musicgen-medium",
                                  "internvl2-76b"])
def test_a_train_step_launches_the_kernels_of_its_path(card, arch):
    """remat full: rmsnorm 4L + 1 and the tc prefill 2L a step; the aux
    term finite; the loss falls over a repeated batch."""
    cfg = _cfg(arch).replace(remat="full")
    L = cfg.num_layers
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, total_steps=30, warmup_steps=1)
    params = T.init_params(cfg, 3)
    opt = adamw.init_state(opt_cfg, params)
    step = train_mod.make_train_step(cfg, opt_cfg)
    batch = _batch(cfg, 2, 16, card, seed=3)
    losses = []
    for i in range(8):
        _zero()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        if i == 0:
            assert _counts() == {"rmsnorm": 4 * L + 1,
                                 "flash_attention_tc": 2 * L}
        assert np.isfinite(float(m["aux"]))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
