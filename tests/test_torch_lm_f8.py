"""F8: token ids out of the embedding table give the reference's logits.

The reference gathers ``e["tok"][tokens]`` by JAX's rule: a negative id
wraps once, then an id still out of range clamps to the table's edge.  The
port gathers through ``core.index.take`` (the same rule), so ids at and
past the padded vocabulary ``V_p`` and below ``-V_p`` give the
reference's logits through ``forward``, ``prefill``, ``decode_step`` and
the ``Engine``, on the reference's parameters, within
``tests/test_torch_lm_models.py``'s 5e-5.  (The embedding's gradient at
such ids is held in ``tests/test_torch_lm_grads.py``.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from test_torch_lm_engine import (_compare, _force_port,  # noqa: E402
                                  _record_reference)
from test_torch_lm_models import TOL, _gap, _params  # noqa: E402


def _jax():
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.models import transformer
    from repro.serve.engine import Engine
    return jnp, registry, transformer, Engine


def _jitted(T, cfg, max_len):
    """The reference's forward, prefill and decode step, jitted."""
    import jax
    return (jax.jit(lambda p, t: T.forward(cfg, p, {"tokens": t})),
            jax.jit(lambda p, t: T.prefill(cfg, p, {"tokens": t},
                                           max_len=max_len)),
            jax.jit(lambda p, c, t: T.decode_step(cfg, p, c, t)))


def _odd_ids(cfg, B, S, seed):
    """Token ids with ``V_p``, ``V_p + 5``, ``-V_p - 3``, ``-1`` and
    ``-V_p`` among in-range ones."""
    Vp = cfg.padded_vocab
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    odd = [Vp, Vp + 5, -Vp - 3, -1, -Vp]
    for b in range(B):
        at = rng.choice(S, len(odd), replace=False)
        toks[b, at] = odd
    return toks


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-3-2b"])
def test_out_of_range_ids_give_the_reference_logits(arch):
    jnp, reg, T, _ = _jax()
    ref_cfg, cfg = reg.smoke(arch), treg.smoke(arch)
    ref_p, p = _params(ref_cfg, 3)
    B, S = 2, 12
    toks = _odd_ids(cfg, B, S, 3)
    forward, prefill, decode_step = _jitted(T, ref_cfg, S)
    want, _ = forward(ref_p, toks)
    got, _ = tT.forward(cfg, p, {"tokens": toks})
    gaps = {"forward": _gap(got, want)}
    Sp = S - 4
    want, rcache = prefill(ref_p, toks[:, :Sp])
    got, cache = tT.prefill(cfg, p, {"tokens": toks[:, :Sp]}, max_len=S)
    gaps["prefill"] = _gap(got, want)
    Vp = cfg.padded_vocab
    for t, nxt in enumerate(([Vp + 5], [-Vp - 3], [Vp], [-1])):
        ids = np.array([nxt] * B, np.int32)
        want, rcache = decode_step(ref_p, rcache, jnp.asarray(ids))
        got, cache = tT.decode_step(cfg, p, cache, ids)
        gaps[f"decode{t}"] = _gap(got, want)
    print(f"{arch}: {gaps}")
    assert max(gaps.values()) <= TOL, gaps


def test_engine_serves_out_of_range_prompts_as_the_reference():
    _, reg, _, Engine = _jax()
    cfg, tcfg = reg.smoke("qwen2-0.5b"), treg.smoke("qwen2-0.5b")
    ref_p, p = _params(cfg, 0)
    prompts = list(_odd_ids(tcfg, 3, 8, 4))
    ref = Engine(cfg, ref_p, slots=2, max_len=24)
    rec_ref = _record_reference(ref, cfg)
    ref_reqs = [ref.submit(q, max_new=4) for q in prompts]
    ref.run(max_steps=100)
    eng = TEngine(tcfg, p, slots=2, max_len=24, device="cpu")
    rec = _force_port(eng, tcfg, rec_ref)
    reqs = [eng.submit(q, max_new=4) for q in prompts]
    eng.run(max_steps=100)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert eng.stats == ref.stats
    gp, _ = _compare(rec["prefill"], rec_ref["prefill"], cfg.vocab_size)
    gd, _ = _compare(rec["decode"], rec_ref["decode"], cfg.vocab_size)
    assert max(gp, gd) <= TOL


def test_engine_free_running_takes_out_of_range_prompts():
    """No reference needed: the engine finishes every request on its own
    init, its tokens in the real vocabulary."""
    cfg = treg.smoke("granite-3-2b")
    eng = TEngine(cfg, tT.init_params(cfg, 0, device="cpu"), slots=2,
                  max_len=24, device="cpu")
    reqs = [eng.submit(q, max_new=5) for q in _odd_ids(cfg, 3, 8, 5)]
    eng.run(max_steps=100)
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
