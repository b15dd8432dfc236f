"""The state-space mixers' path on the card: the kernels at the widths
zamba2 gives them (flash attention at head width 112, rmsnorm in float32
on rows wider than the kernel's one-pass 2,304 floats), and both smoke
archs served through the kernels against the same model's plain path on
the CPU.

Marked ``gpu``; each test skips without a card.  No JAX here: the plain
versions are the yardstick.  Run with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_ssm_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import lower_cuda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

#: a route's lse against its plain version's (tests/test_torch_lm_train_gpu.py)
LSE_TOL = 1e-4
#: tests/test_kernels.py's float32 rmsnorm tolerance
RMSNORM_F32_TOL = 1e-5
#: float32 logits of the kernels against the CPU's plain path: the order
#: of the sums differs (tests/test_torch_lm_gpu.py's 5e-5)
F32_TOL = 5e-5
#: (B, H, Sq, Skv, dtype, causal) at head width 112, MHA as zamba2's
#: shared attention: the tc prefill at several lengths (a partial kv tile
#: at 100 and 1,000), non-causal too, and the decode at several cache
#: lengths
D112 = {"tc-16": (1, 32, 16, 16, torch.bfloat16, True),
        "tc-100": (2, 32, 100, 100, torch.bfloat16, True),
        "tc-1024": (1, 32, 1024, 1024, torch.bfloat16, True),
        "tc-noncausal-70x200": (1, 32, 70, 200, torch.bfloat16, False),
        "decode-1": (4, 32, 1, 1, torch.bfloat16, False),
        "decode-37": (4, 32, 1, 37, torch.bfloat16, False),
        "decode-1000": (1, 32, 1, 1000, torch.bfloat16, False),
        "decode-f32-300": (2, 32, 1, 300, torch.float32, False)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    kernels = {**ops.KERNELS, **lower_cuda.KERNELS}
    return {n: k.launches for n, k in kernels.items() if k.launches}


def _zero():
    for k in (*ops.KERNELS.values(), *lower_cuda.KERNELS.values()):
        k.launches = 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(D112))
def test_flash_at_head_width_112_holds_its_plain_version(card, name):
    B, H, Sq, Skv, dtype, causal = D112[name]
    g = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn(B, H, S, 112, generator=g, device=card).to(dtype)
               for S in (Sq, Skv, Skv))
    route = tfa.route(q, k, v)
    assert route == name.split("-")[0]
    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
    _zero()
    out, lse = tfa.flash_attention(q, k, v, with_lse=True, **kw)
    alone = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _counts() == {ops.ROUTES["flash_attention"][route]: 2}
    plain_out, plain_lse = tfa.plain(q, k, v, with_lse=True, **kw)
    assert torch.equal(out, alone)
    gap = float((lse - plain_lse).abs().max())
    err = float((out.float() - plain_out.float()).abs().max())
    print(f"d=112 {name}: out max-abs gap {err}, lse {gap}")
    assert lse.dtype == torch.float32 and gap <= LSE_TOL
    rtol, atol = tfa.PLAIN_TOL[route, dtype]
    assert torch.allclose(out.float(), plain_out.float(), rtol=rtol,
                          atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [7168, 2305, 2304])
def test_rmsnorm_float32_on_wide_rows_holds_its_plain_version(card, d):
    """7,168 is zamba2's gated norm; 2,305 the narrowest row on the
    kernel's two-pass path, 2,304 the widest on its one-pass path."""
    g = torch.Generator(device=card).manual_seed(d)
    x = torch.randn(333, d, generator=g, device=card)
    scale = torch.randn(d, generator=g, device=card)
    _zero()
    got = trn.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert _counts() == {"rmsnorm": 1}
    want = trn.rmsnorm_plain(x, scale)
    assert torch.allclose(got, want, rtol=RMSNORM_F32_TOL,
                          atol=RMSNORM_F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_smoke_arch_served_on_the_card_holds_the_cpu_plain_path(card, arch):
    """The smoke model in float32, the same weights on both sides: the
    engine's tokens through the kernels on the card equal its tokens
    through the plain versions on the CPU, each prefill and decode step
    launches rmsnorm 2L + A + 1 and its flash kernel A times (A the
    shared attention's applications, 0 for rwkv6; float32 prefills take
    the "simt" kernel, steps the decode kernel), and teacher-forced
    logits agree within F32_TOL."""
    cfg = registry.smoke(arch)
    L, A = cfg.num_layers, (2 if cfg.attn_every else 0)
    cpu_p = T.init_params(cfg, 5, device="cpu")
    p = _to(cpu_p, card)
    rng = np.random.default_rng(5)
    # 10 tokens: a prefill takes the float32 prefill kernel, not the
    # decode route (which takes at most 8 rows of a kv group)
    prompts = [rng.integers(0, cfg.vocab_size, 10) for _ in range(5)]
    outs = []
    for params, dev in ((cpu_p, "cpu"), (p, card)):
        eng = Engine(cfg, params, slots=3, max_len=24, device=dev)
        reqs = [eng.submit(q, max_new=5) for q in prompts]
        _zero()
        eng.run(max_steps=100)
        outs.append([r.out for r in reqs])
    torch.cuda.synchronize()
    steps = eng.stats["steps"]
    want = {"rmsnorm": (2 * L + A + 1) * (5 + steps)}
    if A:
        want.update(flash_attention=A * 5, flash_decode=A * steps)
    assert _counts() == want
    assert outs[0] == outs[1]
    toks = np.stack(prompts[:3])
    lg_c, c_c = T.prefill(cfg, cpu_p, {"tokens": toks}, 16)
    lg_g, c_g = T.prefill(cfg, p, {"tokens": torch.from_numpy(toks).to(card)},
                          16)
    gaps = [float((lg_g.cpu() - lg_c).abs().max())]
    for j in range(4):
        nxt = toks[:, j:j + 1]
        lg_c, c_c = T.decode_step(cfg, cpu_p, c_c, nxt)
        lg_g, c_g = T.decode_step(cfg, p, c_g,
                                  torch.from_numpy(nxt).to(card))
        gaps.append(float((lg_g.cpu() - lg_c).abs().max()))
    print(f"{arch}: logits max-abs gaps {gaps}")
    assert max(gaps) <= F32_TOL


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.gpu
def test_zamba2_train_step_recomputes_each_layer_once_on_the_card(card):
    """remat full on the smoke hybrid in bfloat16: rmsnorm 2(2L + A) + 1
    and flash_attention_tc 2A a step, no other kernel; the loss falls."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_mod
    cfg = registry.smoke("zamba2-7b").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")
    L, A = cfg.num_layers, 2
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, total_steps=30, warmup_steps=1)
    params = T.init_params(cfg, 3)
    opt = adamw.init_state(opt_cfg, params)
    step = train_mod.make_train_step(cfg, opt_cfg)
    batch = {"tokens": np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16))}
    losses = []
    for i in range(8):
        _zero()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        if i == 0:
            assert _counts() == {"rmsnorm": 2 * (2 * L + A) + 1,
                                 "flash_attention_tc": 2 * A}
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
