"""The LM training path on the card: the train step launches the
hand-written RMSNorm and flash kernels, and only them, and holds the same
step through their plain versions; each flash route's logsumexp holds its
plain version; checkpoints save and resume there; F8's out-of-range
prompt is served.

Marked ``gpu``; each test skips without a card.  No JAX here (the machine
with the card has none): the plain versions (``mode="interpret"``) on the
card are the yardstick.  Run with ``PYTHONPATH=src python -m pytest -q -m
gpu tests/test_torch_lm_train_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import lower_cuda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

#: a train step through the kernels against the same step through their
#: plain versions on the card: the loss and grad norm (relative), each
#: gradient leaf and each parameter after the update (||d|| / ||x||).
#: float32 kernels and plain versions differ by the order of their sums;
#: in bfloat16 a kernel's value may land on the neighbouring bfloat16
#: value (flash_attention.PLAIN_TOL), which the backward carries into
#: every gradient
STEP_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: a route's lse against its plain version's: both take the same float32
#: maximum and sum up to the order of the sum and the prefill kernels'
#: exp2 of pre-scaled scores (max-abs, natural-log units)
LSE_TOL = 1e-4
#: (arch, dtype): cupbop-demo-120m's smoke model in float32 (the "simt"
#: prefill) and qwen2-0.5b's in bfloat16 (the "tc" prefill)
CASES = [("cupbop-demo-120m", torch.float32),
         ("qwen2-0.5b", torch.bfloat16)]
KERNEL_OF = {torch.float32: "flash_attention",
             torch.bfloat16: "flash_attention_tc"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(arch, dtype, **kw):
    name = str(dtype).removeprefix("torch.")
    return registry.smoke(arch).replace(param_dtype=name, compute_dtype=name,
                                        **kw)


def _counts():
    out = {n: k.launches for n, k in ops.KERNELS.items()}
    out.update((n, k.launches) for n, k in lower_cuda.KERNELS.items())
    return {n: c for n, c in out.items() if c}


def _zero():
    for k in (*ops.KERNELS.values(), *lower_cuda.KERNELS.values()):
        k.launches = 0


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(
        min=1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", CASES)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_launches_the_kernels_and_holds_the_plain_step(
        card, arch, dtype, remat):
    cfg = _cfg(arch, dtype, remat=remat)
    L = cfg.num_layers
    params = T.init_params(cfg, 3)
    batch = {"tokens": np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)}
    runs = {}
    for mode in ("interpret", None):
        _zero()
        loss = tstep.make_loss(cfg, mode=mode)
        runs[mode] = tstep.value_and_grad(loss, params, batch)
        torch.cuda.synchronize()
        counts = _counts()
        if mode is None:
            again = 2 if remat == "full" else 1
            assert counts == {"rmsnorm": again * 2 * L + 1,
                              KERNEL_OF[dtype]: again * L}, counts
        else:
            assert counts == {}, counts
    (lp, _), gp = runs["interpret"]
    (lk, _), gk = runs[None]
    tol = STEP_TOL[dtype]
    assert abs(float(lk) - float(lp)) <= tol * abs(float(lp))
    gaps = [_rel(a, b) for a, b in zip(adamw.tree_leaves(gk),
                                       adamw.tree_leaves(gp), strict=True)]
    print(f"{arch}/{dtype}/{remat}: loss {float(lk)} vs {float(lp)}, worst "
          f"grad leaf {max(gaps)}")
    assert max(gaps) <= tol
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=1)
    st = adamw.init_state(opt_cfg, params)
    pk, _, mk = adamw.apply_updates(opt_cfg, params, gk, st)
    pp, _, mp = adamw.apply_updates(opt_cfg, params, gp, st)
    assert abs(float(mk["grad_norm"]) - float(mp["grad_norm"])) <= \
        tol * float(mp["grad_norm"])
    assert max(_rel(a, b) for a, b in zip(
        adamw.tree_leaves(pk), adamw.tree_leaves(pp), strict=True)) <= tol


#: (B, H, Hkv, Sq, Skv, dtype, causal) reaching each route's kernel
LSE_CASES = {"simt": (2, 8, 2, 300, 300, torch.float32, True),
             "tc": (2, 8, 2, 300, 300, torch.bfloat16, True),
             "tc-noncausal": (1, 4, 4, 70, 200, torch.bfloat16, False),
             "decode": (3, 8, 2, 1, 1000, torch.bfloat16, False),
             "decode-f32": (3, 8, 8, 1, 1000, torch.float32, False),
             "decode-prompt": (2, 4, 4, 6, 6, torch.float32, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(LSE_CASES))
def test_each_route_lse_holds_its_plain_version(card, name):
    B, H, Hkv, Sq, Skv, dtype, causal = LSE_CASES[name]
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(B, H, Sq, 64, generator=g, device=card).to(dtype)
    k = torch.randn(B, Hkv, Skv, 64, generator=g, device=card).to(dtype)
    v = torch.randn(B, Hkv, Skv, 64, generator=g, device=card).to(dtype)
    route = tfa.route(q, k, v)
    assert route == name.split("-")[0]
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    _zero()
    out, lse = tfa.flash_attention(q, k, v, with_lse=True, **kw)
    plain_out, plain_lse = tfa.plain(q, k, v, with_lse=True, **kw)
    alone = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _counts() == {ops.ROUTES["flash_attention"][route]: 2}
    assert torch.equal(out, alone)          # serving's output, unchanged
    gap = float((lse - plain_lse).abs().max())
    print(f"{name}: lse max-abs gap {gap}")
    assert lse.dtype == torch.float32 and gap <= LSE_TOL
    rtol, atol = tfa.PLAIN_TOL[route, dtype]
    assert torch.allclose(out.float(), plain_out.float(), rtol=rtol,
                          atol=atol)


@pytest.mark.gpu
def test_checkpoint_saves_and_resumes_on_the_card(card, tmp_path):
    cfg = _cfg("qwen2-0.5b", torch.bfloat16)
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=1)
    params = T.init_params(cfg, 4)
    opt = adamw.init_state(opt_cfg, params)
    step = tstep.make_train_step(cfg, opt_cfg)
    batch = {"tokens": np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    params, opt, _ = step(params, opt, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, (params, opt), extra={"data_step": 1}, blocking=True)
    blank = T.init_params(cfg, 9)
    (p2, o2), extra = mgr.restore((blank, adamw.init_state(opt_cfg, blank)))
    assert extra == {"data_step": 1} and int(o2.step) == 1
    for a, b in zip(adamw.tree_leaves(p2) + adamw.tree_leaves(o2.m),
                    adamw.tree_leaves(params) + adamw.tree_leaves(opt.m),
                    strict=True):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    _, _, m = step(p2, o2, batch)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.gpu
def test_out_of_range_prompt_is_served_on_the_card(card):
    """F8: ids at and past the padded vocabulary and below its negative
    gather as JAX's (wrap once, clamp), and no device-side assert ends the
    context."""
    cfg = _cfg("qwen2-0.5b", torch.bfloat16)
    params = T.init_params(cfg, 6)
    Vp = cfg.padded_vocab
    prompt = np.array([3, Vp, Vp + 5, 7, -Vp - 3, -1, 11, Vp - 1])
    got, _ = T.forward(cfg, params, {"tokens": prompt[None]})
    want, _ = T.forward(cfg, params, {"tokens": prompt[None]},
                        mode="interpret")
    assert float((got - want).abs().max()) <= 1e-2
    clamped = np.where(prompt < 0, prompt + Vp, prompt).clip(0, Vp - 1)
    same, _ = T.forward(cfg, params, {"tokens": clamped[None]})
    assert torch.equal(got, same)
    eng = Engine(cfg, params, slots=2, max_len=24)
    reqs = [eng.submit(prompt, max_new=4), eng.submit(prompt[::-1].copy(),
                                                      max_new=4)]
    eng.run(max_steps=50)
    torch.cuda.synchronize()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
