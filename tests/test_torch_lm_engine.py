"""The port's continuous-batching LM engine against the reference's.

``tests/test_system.py``'s traffic (5 requests on 3 slots: the last two
are admitted after the first three have advanced, so they meet the shared
``pos`` the reference's engine keeps), and the serve command's (whose
shared ``pos`` runs past the cache's end) run through both engines on the
reference's parameters.  The comparison is teacher-forced: both engines
record each prefill's and decode step's logits, and the port's engine is
fed the reference's tokens, so one near-tie cannot make the streams part.
Logits agree within 5e-5 max-abs; greedy tokens agree wherever the
reference's top-1 / top-2 margin exceeds it (the count of rows under the
margin is printed); ``launches``, ``syncs`` and ``steps`` are equal.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.streams import Policy as TPolicy  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 5e-5


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.core.streams import Policy
    from repro.models import transformer
    from repro.serve.engine import Engine
    return jax, jnp, registry, Policy, transformer, Engine


def _params(arch, seed=0):
    """The reference's smoke config and parameters, and the port's copy."""
    jax, _, reg, _, T, _ = _jax()
    cfg = reg.smoke(arch)
    params = T.init_params(cfg, jax.random.PRNGKey(seed))
    host = jax.tree.map(np.asarray, params)
    return cfg, params, carry.params_from_reference(host, device="cpu")


def _record_reference(eng, cfg):
    """Wrap the reference engine's jitted prefill and decode so each call's
    last-position logits and greedy tokens are kept, in call order."""
    jax, jnp, _, _, T, _ = _jax()
    rec = {"prefill": [], "decode": []}
    dec = jax.jit(lambda p, c, t: T.decode_step(cfg, p, c, t))
    pre = jax.jit(lambda p, t: T.prefill(cfg, p, {"tokens": t},
                                         max_len=eng.max_len))

    def greedy(logits):
        return jnp.argmax(logits[:, -1, :cfg.vocab_size],
                          axis=-1).astype(jnp.int32)[:, None]

    def _decode(params, cache, toks):
        logits, cache = dec(params, cache, toks)
        nxt = greedy(logits)
        rec["decode"].append((np.asarray(logits[:, -1]), np.asarray(nxt)))
        return nxt, cache

    def _prefill(params, toks):
        logits, cache = pre(params, toks)
        nxt = greedy(logits)
        rec["prefill"].append((np.asarray(logits[:, -1]), np.asarray(nxt)))
        return nxt, cache

    eng._decode, eng._prefill = _decode, _prefill
    return rec


def _force_port(eng, cfg, forced):
    """Wrap the port engine's prefill and decode so each call's logits are
    kept and the reference's tokens (``forced``) are fed back."""
    rec = {"prefill": [], "decode": []}

    def _decode(toks):
        logits, eng.cache = tT.decode_step(cfg, eng.params, eng.cache, toks)
        rec["decode"].append(logits[:, -1].numpy())
        _, nxt = forced["decode"][len(rec["decode"]) - 1]
        return torch.from_numpy(np.array(nxt)).long()

    def _prefill(prompt):
        logits, cache = tT.prefill(cfg, eng.params, {"tokens": prompt[None]},
                                   max_len=eng.max_len)
        rec["prefill"].append(logits[:, -1].numpy())
        _, nxt = forced["prefill"][len(rec["prefill"]) - 1]
        return torch.from_numpy(np.array(nxt)).long(), cache

    eng._decode, eng._prefill = _decode, _prefill
    return rec


def _compare(mine, ref, vocab):
    """Max-abs gap of each call's logits, the margin rule; returns (gap,
    rows under the margin)."""
    assert len(mine) == len(ref)
    gap, under = 0.0, 0
    for got, (want, _) in zip(mine, ref):
        gap = max(gap, float(np.abs(got - want).max()))
        top2 = np.sort(want[:, :vocab], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > TOL
        assert (got[:, :vocab].argmax(-1)
                == want[:, :vocab].argmax(-1))[clear].all()
        under += int((~clear).sum())
    return gap, under


def _submit(eng, cfg, n, prompt_len, max_new, seed):
    rng = np.random.default_rng(seed)
    return [eng.submit(rng.integers(0, cfg.vocab_size, prompt_len),
                       max_new=max_new) for _ in range(n)]


#: (slots, max_len, requests, prompt tokens, new tokens, the final shared
#: pos): tests/test_system.py's traffic, whose last two requests are
#: admitted at pos 13, and the serve command's (--lm's defaults), whose
#: shared pos runs past max_len, where the reference's cache write clamps
TRAFFIC = {"system": (3, 48, 5, 8, 6, 18), "cli": (4, 36, 8, 16, 12, 38)}


@pytest.mark.parametrize("arch,traffic", [("qwen2-0.5b", "system"),
                                          ("granite-3-2b", "system"),
                                          ("qwen2-0.5b", "cli")])
def test_engine_matches_the_reference_teacher_forced(arch, traffic):
    _, _, _, _, _, Engine = _jax()
    slots, max_len, n, prompt_len, max_new, pos = TRAFFIC[traffic]
    cfg, params, p = _params(arch)
    tcfg = treg.smoke(arch)
    ref = Engine(cfg, params, slots=slots, max_len=max_len)
    rec_ref = _record_reference(ref, cfg)
    ref_reqs = _submit(ref, cfg, n, prompt_len, max_new, 0)
    ref.run(max_steps=200)
    assert all(r.done and len(r.out) == max_new for r in ref_reqs)

    eng = TEngine(tcfg, p, slots=slots, max_len=max_len, device="cpu")
    rec = _force_port(eng, tcfg, rec_ref)
    reqs = _submit(eng, tcfg, n, prompt_len, max_new, 0)
    eng.run(max_steps=200)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert eng.stats == ref.stats
    assert eng.cache["pos"] == int(ref.cache["pos"]) == pos
    gp, up = _compare(rec["prefill"], rec_ref["prefill"], cfg.vocab_size)
    gd, ud = _compare(rec["decode"], rec_ref["decode"], cfg.vocab_size)
    print(f"{arch}/{traffic}: prefill gap {gp}, decode gap {gd}, rows under "
          f"the margin {up + ud}, stats {eng.stats}")
    assert max(gp, gd) <= TOL
    np.testing.assert_allclose(eng.cache["k"].numpy(),
                               np.asarray(ref.cache["k"]), rtol=0, atol=TOL)

    # free-running, the port's engine gives the reference's tokens when no
    # row fell under the margin
    free = TEngine(tcfg, p, slots=slots, max_len=max_len, device="cpu")
    free_reqs = _submit(free, tcfg, n, prompt_len, max_new, 0)
    free.run(max_steps=200)
    assert free.stats == ref.stats
    if up + ud == 0:
        assert [r.out for r in free_reqs] == [r.out for r in ref_reqs]


def test_engine_policies_same_tokens_and_reference_syncs():
    """HAZARD_ONLY and SYNC_ALWAYS produce identical tokens; hazard-only
    never syncs more often; each policy's stats are the reference's."""
    _, _, _, Policy, _, Engine = _jax()
    cfg, params, p = _params("qwen2-0.5b")
    tcfg = treg.smoke("qwen2-0.5b")
    outs, stats = {}, {}
    for pol, tpol in ((Policy.HAZARD_ONLY, TPolicy.HAZARD_ONLY),
                      (Policy.SYNC_ALWAYS, TPolicy.SYNC_ALWAYS)):
        ref = Engine(cfg, params, slots=2, max_len=32, policy=pol)
        ref_reqs = _submit(ref, cfg, 2, 6, 5, 1)
        ref.run(max_steps=50)
        eng = TEngine(tcfg, p, slots=2, max_len=32, policy=tpol,
                      device="cpu")
        reqs = _submit(eng, tcfg, 2, 6, 5, 1)
        eng.run(max_steps=50)
        outs[tpol] = [r.out for r in reqs]
        stats[tpol] = dict(eng.stats)
        assert eng.stats == ref.stats
        assert outs[tpol] == [r.out for r in ref_reqs]
    assert outs[TPolicy.HAZARD_ONLY] == outs[TPolicy.SYNC_ALWAYS]
    assert (stats[TPolicy.HAZARD_ONLY]["syncs"]
            <= stats[TPolicy.SYNC_ALWAYS]["syncs"])


def test_engine_serves_batched_requests_on_its_own_init():
    cfg = treg.smoke("qwen2-0.5b")
    eng = TEngine(cfg, tT.init_params(cfg, 0, device="cpu"), slots=3,
                  max_len=48, device="cpu")
    reqs = _submit(eng, cfg, 5, 8, 6, 0)
    eng.run(max_steps=200)
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    assert eng.stats == {"launches": 5 + 10, "syncs": 5 + 10, "steps": 10}


def test_greedy_decode_deterministic():
    cfg = treg.smoke("granite-3-2b")
    params = tT.init_params(cfg, 0, device="cpu")
    outs = []
    for _ in range(2):
        eng = TEngine(cfg, params, slots=1, max_len=24, device="cpu")
        r = eng.submit(np.arange(6) % cfg.vocab_size, max_new=6)
        eng.run(max_steps=50)
        outs.append(tuple(r.out))
    assert outs[0] == outs[1]


def test_engine_runs_on_the_card_unless_asked():
    cfg = treg.smoke("qwen2-0.5b")
    params = tT.init_params(cfg, 0, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params lie on cpu"):
            TEngine(cfg, params)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEngine(cfg, params)


def test_serve_lm_command_runs_and_counts_as_the_reference():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lm",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert res.returncode == 0, res.stderr
    m = re.search(r"served 8 requests, 96 tokens .* launches=(\d+) "
                  r"syncs=(\d+)", res.stdout)
    assert m, res.stdout
    from repro.launch import serve
    want = serve.main(["--lm"])
    assert (int(m[1]), int(m[2])) == (want["launches"], want["syncs"])
