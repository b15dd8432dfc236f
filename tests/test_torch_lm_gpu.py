"""The LM serving path on the card: the engine launches the hand-written
kernels, and only them, and the model's logits hold their plain versions.

Marked ``gpu``; each test skips without a card.  No JAX here (the machine
with the card has none): the plain versions (``mode="interpret"``) on the
card are the yardstick.  Run with ``PYTHONPATH=src python -m pytest -q -m
gpu tests/test_torch_lm_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import lower_cuda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

#: max-abs gap of the kernels' logits from their plain versions' on the
#: card: float32 kernels and plain versions differ by the order of their
#: sums (measured at most 7.2e-7 on an H100); in bfloat16 a kernel's value
#: may land on the neighbouring bfloat16 value (PLAIN_TOL), which later
#: products carry into the logits (measured 0 at these sizes on an H100;
#: at qwen2-0.5b's full width chip_smoke.py measures up to 2.4e-3)
TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}
#: (arch, dtype): the smoke configs in bfloat16 (prefill on the "tc"
#: route), cupbop-demo-120m's in float32 (the "simt" route)
CASES = [("qwen2-0.5b", torch.bfloat16), ("granite-3-2b", torch.bfloat16),
         ("cupbop-demo-120m", torch.bfloat16),
         ("cupbop-demo-120m", torch.float32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(arch, dtype):
    name = str(dtype).removeprefix("torch.")
    return registry.smoke(arch).replace(param_dtype=name, compute_dtype=name)


def _counts():
    out = {n: k.launches for n, k in ops.KERNELS.items()}
    out.update((n, k.launches) for n, k in lower_cuda.KERNELS.items())
    return out


def _zero():
    for k in (*ops.KERNELS.values(), *lower_cuda.KERNELS.values()):
        k.launches = 0


def _flash_kernel(cfg, B, Sq, Skv, dev):
    """The ``ops.KERNELS`` name of the flash kernel that ``route`` picks
    for the model's attention at these shapes."""
    plan = attention.plan_for(cfg)
    q = torch.empty(B, plan.hq_p, Sq, cfg.hd, dtype=cfg.cdtype, device=dev)
    kv = torch.empty(B, plan.hkv_p, Skv, cfg.hd, dtype=cfg.cdtype,
                     device=dev)
    return ops.ROUTES["flash_attention"][tfa.route(q, kv, kv)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", CASES)
def test_engine_launches_the_kernels_of_its_path(card, arch, dtype):
    """tests/test_system.py's traffic on the card: each prefill and decode
    step launches rmsnorm 2L + 1 times and its routed flash kernel L
    times; no other kernel runs."""
    cfg = _cfg(arch, dtype)
    L, slots, prompt = cfg.num_layers, 3, 8
    eng = Engine(cfg, T.init_params(cfg, 0), slots=slots, max_len=48)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, prompt), max_new=6)
            for _ in range(5)]
    _zero()
    eng.run(max_steps=200)
    torch.cuda.synchronize()
    assert all(r.done and len(r.out) == 6 for r in reqs)
    prefills, steps = eng.stats["launches"] - eng.stats["steps"], \
        eng.stats["steps"]
    assert (prefills, steps) == (5, 10)
    want = {n: 0 for n in _counts()}
    want["rmsnorm"] = (2 * L + 1) * (prefills + steps)
    pre = _flash_kernel(cfg, 1, prompt, prompt, card)
    dec = _flash_kernel(cfg, slots, 1, 1, card)
    assert dec == _flash_kernel(cfg, slots, 1, 48, card) == "flash_decode"
    want[pre] += L * prefills
    want[dec] += L * steps
    assert _counts() == want


def _greedy(logits, vocab):
    return logits[:, -1, :vocab].argmax(-1)[:, None]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", CASES)
def test_model_logits_hold_the_plain_versions(card, arch, dtype):
    """Prefill and 6 decode steps, kernels against plain versions on the
    same parameters, teacher-forced with the plain versions' greedy
    tokens: logits within TOL, tokens equal wherever the plain version's
    top-1 / top-2 margin exceeds it."""
    cfg = _cfg(arch, dtype)
    params = T.init_params(cfg, 1)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16))).to(card)
    tol, gaps, under = TOL[dtype], [], 0

    def check(got, want):
        nonlocal under
        gaps.append(float((got - want).abs().max()))
        ref = want[:, -1, :cfg.vocab_size]
        top2 = ref.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > tol
        agree = got[:, -1, :cfg.vocab_size].argmax(-1) == ref.argmax(-1)
        assert bool(agree[clear].all())
        under += int((~clear).sum())

    want, wcache = T.prefill(cfg, params, {"tokens": toks}, max_len=24,
                             mode="interpret")
    _zero()
    got, cache = T.prefill(cfg, params, {"tokens": toks}, max_len=24)
    torch.cuda.synchronize()
    pre = _flash_kernel(cfg, 2, 16, 16, card)
    assert pre == {torch.bfloat16: "flash_attention_tc",
                   torch.float32: "flash_attention"}[dtype]
    assert _counts()[pre] == cfg.num_layers
    check(got, want)
    nxt = _greedy(want, cfg.vocab_size)
    for _ in range(6):
        want, wcache = T.decode_step(cfg, params, wcache, nxt,
                                     mode="interpret")
        got, cache = T.decode_step(cfg, params, cache, nxt)
        check(got, want)
        nxt = _greedy(want, cfg.vocab_size)
    print(f"{arch}/{dtype}: gaps {gaps}; rows under the margin {under}")
    assert max(gaps) <= tol, gaps
    assert all(np.isfinite(gaps))
