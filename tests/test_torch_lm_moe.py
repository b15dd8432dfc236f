"""The port's mixture-of-experts decoder against the reference's, on the
CPU.

``moe_block`` on the deepseek-moe-16b smoke config's experts, both
dispatch modes, at a capacity that drops nothing (8.0) and at the config's
1.25 over inputs that overflow it: the outputs and aux within 1e-5, and
every expert slot holding the reference's token (the dropped set equal,
and not empty at 1.25).  Equal gates pick the reference's experts; a
token count that halves the group to 2 tokens routes as the reference's;
the sort path's scatter-add gives the reference's bfloat16 bits.  The
whole model (grok-1-314b and deepseek-moe-16b smoke, both modes) on the
reference's parameters: forward, prefill and teacher-forced decode logits
within 5e-5, aux within 1e-5, the reference's
``test_moe_consistency_no_drop``, and a decode batch's rows sharing
capacity as the reference's do (the ``Engine`` on these configs is held in
``tests/test_torch_lm_audio_vlm.py``).  Each reference result is computed
once per module.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from test_torch_lm_models import _gap, _params  # noqa: E402

TOL = 5e-5
MOE_TOL = 1e-5
ARCHS = ["grok-1-314b", "deepseek-moe-16b"]
#: (arch, dispatch) cases of the whole model
MODEL_CASES = [("grok-1-314b", "einsum"), ("deepseek-moe-16b", "einsum"),
               ("deepseek-moe-16b", "sort")]


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.models import moe, transformer
    return jax, jnp, registry, moe, transformer


def _cfgs(arch, **moe_kw):
    """(reference config, port config), their MoE fields replaced."""
    _, _, reg, _, _ = _jax()
    rc, c = reg.smoke(arch), treg.smoke(arch)
    if moe_kw:
        rc = rc.replace(moe=dataclasses.replace(rc.moe, **moe_kw))
        c = c.replace(moe=dataclasses.replace(c.moe, **moe_kw))
    return rc, c


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---- moe_block ----------------------------------------------------------
def _record(mod, seen):
    """Wrap ``mod``'s ``_route`` and ``_expert_ffn`` so each call's top
    indices and dispatched expert inputs land in ``seen``; returns the
    undo."""
    route, ffn = mod._route, mod._expert_ffn

    def _route(cfg, p, xt):
        out = route(cfg, p, xt)
        seen["idx"] = _np(out[1]).astype(np.int64)
        return out

    def _expert_ffn(cfg, p, xe):
        seen["xe"] = _np(xe)
        return ffn(cfg, p, xe)

    mod._route, mod._expert_ffn = _route, _expert_ffn

    def undo():
        mod._route, mod._expert_ffn = route, ffn
    return undo


def _slots(xe, xt):
    """{(group, expert, slot, token)} of every filled slot: the token
    whose row the slot holds."""
    match = (xe[:, :, :, None, :] == xt[:, None, None, :, :]).all(-1)
    filled = np.abs(xe).sum(-1) > 0
    assert (match.sum(-1) == filled).all()          # each row one token's
    return {tuple(int(v) for v in t) for t in np.argwhere(match)}


def _block_inputs(cfg, T, shared, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, cfg.d_model)) + \
        shared * rng.standard_normal(cfg.d_model)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_block(dispatch, factor, T, shared):
    """The reference's moe_block on the deepseek smoke experts: (expert
    params as NumPy, x, y, aux, top indices, filled slots)."""
    jax, jnp, _, moe, _ = _jax()
    rc, _ = _cfgs("deepseek-moe-16b", dispatch=dispatch,
                  capacity_factor=factor)
    host = jax.tree.map(np.asarray, moe.init_moe_params(
        jax.random.PRNGKey(3), rc))
    x = _block_inputs(rc, T, shared, 4)
    seen = {}
    undo = _record(moe, seen)
    try:
        y, aux = moe.moe_block(rc, jax.tree.map(jnp.asarray, host),
                               jnp.asarray(x))
    finally:
        undo()
    G = seen["idx"].shape[0]
    xt = x.reshape(G, -1, rc.d_model)
    return host, x, _np(y), float(aux), seen["idx"], _slots(seen["xe"], xt)


def _port_block(dispatch, factor, host, x):
    _, cfg = _cfgs("deepseek-moe-16b", dispatch=dispatch,
                   capacity_factor=factor)
    seen = {}
    undo = _record(tmoe, seen)
    try:
        y, aux = tmoe.moe_block(cfg, carry.params_from_reference(
            host, device="cpu"), torch.from_numpy(x))
    finally:
        undo()
    G = seen["idx"].shape[0]
    xt = x.reshape(G, -1, cfg.d_model)
    return _np(y), float(aux), seen["idx"], _slots(seen["xe"], xt)


def _dropped(idx, slots):
    """{(group, token, expert)} chosen but given no slot."""
    kept = {(g, t, e) for g, e, _, t in slots}
    chosen = {(g, t, int(e)) for g, t, j in np.ndindex(idx.shape)
              for e in [idx[g, t, j]]}
    return chosen - kept


@pytest.mark.parametrize("factor,shared", [(8.0, 0.0), (1.25, 1.0)],
                         ids=["no-drop", "overflow"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_block_matches_the_reference_and_drops_its_tokens(dispatch,
                                                              factor, shared):
    host, x, want, waux, widx, wslots = _reference_block(dispatch, factor,
                                                         128, shared)
    got, aux, idx, slots = _port_block(dispatch, factor, host, x)
    assert np.array_equal(idx, widx)
    assert slots == wslots                    # each slot the same token
    dropped = _dropped(widx, wslots)
    assert _dropped(idx, slots) == dropped
    assert bool(dropped) == (factor == 1.25), len(dropped)
    assert float(np.abs(got - want).max()) <= MOE_TOL
    assert abs(aux - waux) <= MOE_TOL


def test_the_two_modes_drop_other_tokens_as_the_reference_does():
    """At overflow the einsum mode serves every first choice before any
    second one, the sort mode token by token: their dropped sets differ,
    on both sides alike."""
    ein = _reference_block("einsum", 1.25, 128, 1.0)
    srt = _reference_block("sort", 1.25, 128, 1.0)
    assert _dropped(ein[4], ein[5]) != _dropped(srt[4], srt[5])

    def firsts_first(idx, slots):
        """No expert keeps a second choice after dropping a first one."""
        dropped = _dropped(idx, slots)
        for g, t, e in dropped:
            if idx[g, t, 0] == e:
                later = [(g, u, e) for u in range(idx.shape[1])
                         if idx[g, u, 1] == e]
                if not all(c in dropped for c in later):
                    return False
        return True
    assert firsts_first(ein[4], ein[5])
    assert not firsts_first(srt[4], srt[5])


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_a_token_count_that_halves_the_group_to_two(dispatch):
    """T = 66 at group_size 64: 64, 32, 16, 8 and 4 do not divide it, so
    gs = 2 and 33 groups, C = max(4, ...) = 4."""
    host, x, want, waux, widx, wslots = _reference_block(dispatch, 1.25, 66,
                                                         1.0)
    assert widx.shape == (33, 2, 2)
    got, aux, idx, slots = _port_block(dispatch, 1.25, host, x)
    assert np.array_equal(idx, widx) and slots == wslots
    assert float(np.abs(got - want).max()) <= MOE_TOL
    assert abs(aux - waux) <= MOE_TOL


def test_capacity_is_the_references():
    _, _, _, moe, _ = _jax()
    for args in [(64, 2, 4, 1.25), (2, 2, 4, 1.25), (1024, 6, 64, 1.25),
                 (4, 6, 64, 1.25), (37, 3, 5, 8.0), (1000, 2, 8, 1.0)]:
        assert tmoe._capacity(*args) == moe._capacity(*args), args


def test_equal_gates_pick_the_reference_experts():
    """A router whose columns 1, 2 and 3 are equal gives those experts the
    same gate for every token: lax.top_k takes the lower index first, and
    so does the port's stable sort."""
    jax, jnp, _, moe, _ = _jax()
    rc, cfg = _cfgs("deepseek-moe-16b", num_experts=6, top_k=3)
    host = jax.tree.map(np.asarray, moe.init_moe_params(
        jax.random.PRNGKey(5), rc))
    r = host["router"].copy()
    r[:, 2] = r[:, 3] = r[:, 1]
    r[:, 5] = r[:, 0]
    host["router"] = r
    xt = np.random.default_rng(6).standard_normal(
        (2, 16, rc.d_model)).astype(np.float32)
    ww, widx, waux = moe._route(rc, jax.tree.map(jnp.asarray, host),
                                jnp.asarray(xt))
    w, idx, aux = tmoe._route(cfg, carry.params_from_reference(
        host, device="cpu"), torch.from_numpy(xt))
    assert np.array_equal(idx.numpy(), np.asarray(widx))
    assert float(np.abs(_np(w) - _np(ww)).max()) <= MOE_TOL
    assert abs(float(aux) - float(waux)) <= MOE_TOL
    # the ties were really there: some token's top 3 holds tied experts
    gates = np.asarray(jax.nn.softmax(jnp.asarray(xt) @ r, -1))
    top = np.sort(gates, -1)[..., ::-1][..., :4]
    assert (np.diff(top, axis=-1) == 0).any()
    for vals in ([[0.2, 0.3, 0.3, 0.2]], [[0.5, 0.5, 0.5, 0.5]]):
        g = np.asarray(vals, np.float32)
        want = np.asarray(jax.lax.top_k(jnp.asarray(g), 3)[1])
        assert np.array_equal(tmoe.top_k(torch.from_numpy(g), 3)[1].numpy(),
                              want)


def test_sort_scatter_add_gives_the_references_bfloat16_bits():
    """``yt.at[g, stok].add(contrib)`` in bfloat16: JAX's CPU scatter adds
    a token's contributions in their sorted order, and so does the port on
    any device; the opposite order gives other bits."""
    _, jnp, _, _, _ = _jax()
    rng = np.random.default_rng(7)
    G, gs, k, D = 2, 16, 3, 8
    reversed_differs = False
    for _ in range(6):
        fe = np.stack([np.stack([rng.choice(6, k, replace=False)
                                 for _ in range(gs)]) for _ in range(G)])
        order = np.argsort(fe.reshape(G, gs * k), axis=1, kind="stable")
        stok = np.repeat(np.arange(gs), k)[order]
        contrib = (rng.standard_normal((G, gs * k, D)) * np.exp(
            rng.uniform(-4, 4, (G, gs * k, 1)))).astype(np.float32)
        gidx = np.broadcast_to(np.arange(G)[:, None], (G, gs * k))
        want = np.asarray(jnp.zeros((G, gs, D), jnp.bfloat16).at[
            gidx, stok].add(jnp.asarray(contrib).astype(jnp.bfloat16)
                            ).astype(jnp.float32))
        c = torch.from_numpy(contrib).bfloat16()
        got = tmoe._ordered_token_sum(c, torch.from_numpy(order), gs, k,
                                      torch.bfloat16)
        assert np.array_equal(got.float().numpy(), want)
        back = tmoe._ordered_token_sum(c.flip(1), torch.from_numpy(
            order).flip(1), gs, k, torch.bfloat16)
        reversed_differs |= not np.array_equal(back.float().numpy(), want)
    assert reversed_differs


def test_moe_params_match_the_reference_shapes_dtypes_and_bounds():
    """A layer's experts (the port's layer 0 of its stack) against the
    reference's ``init_moe_params``, in bfloat16."""
    jax, _, reg, moe, _ = _jax()
    rc = reg.smoke("deepseek-moe-16b").replace(param_dtype="bfloat16")
    want = jax.tree.map(np.asarray, moe.init_moe_params(
        jax.random.PRNGKey(0), rc))
    got = tT.layer_params(tT.init_params(treg.smoke(
        "deepseek-moe-16b").replace(param_dtype="bfloat16"), 0,
        device="cpu"), 0)["moe"]

    def walk(w, g, path=""):
        assert set(w) == set(g), path
        for k in w:
            if isinstance(w[k], dict):
                walk(w[k], g[k], f"{path}/{k}")
                continue
            assert tuple(g[k].shape) == w[k].shape, f"{path}/{k}"
            assert str(g[k].dtype).removeprefix("torch.") == \
                w[k].dtype.name, f"{path}/{k}"
            bound = float(np.abs(np.asarray(w[k], np.float32)).max())
            gbound = float(g[k].float().abs().max())
            assert 0.9 * bound <= gbound <= bound * 1.01, f"{path}/{k}"
    walk(want, got)


# ---- the model ----------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_model(arch, dispatch, factor=1.25, B=2, S=16):
    """The reference's forward, prefill and teacher-forced decode steps
    on its perturbed parameters: (host params, tokens, full logits, aux,
    prefill logits, decode logits)."""
    jax, jnp, _, _, T = _jax()
    rc, _ = _cfgs(arch, dispatch=dispatch, capacity_factor=factor)
    ref_p, _ = _params(rc, 0)
    host = jax.tree.map(np.asarray, ref_p)
    toks = np.random.default_rng(0).integers(0, rc.vocab_size,
                                             (B, S)).astype(np.int32)
    full, aux = jax.jit(lambda p, t: T.forward(rc, p, {"tokens": t}))(
        ref_p, toks)
    Sp = S - 4
    pre, cache = jax.jit(lambda p, t: T.prefill(rc, p, {"tokens": t},
                                                max_len=S))(
        ref_p, toks[:, :Sp])
    dec = jax.jit(lambda p, c, t: T.decode_step(rc, p, c, t))
    steps = []
    for t in range(Sp, S):
        lg, cache = dec(ref_p, cache, jnp.asarray(toks[:, t:t + 1]))
        steps.append(_np(lg))
    return host, toks, _np(full), float(aux), _np(pre), steps


@pytest.mark.parametrize("arch,dispatch", MODEL_CASES)
def test_logits_and_aux_match_the_reference(arch, dispatch):
    host, toks, full, aux, pre, steps = _reference_model(arch, dispatch)
    _, cfg = _cfgs(arch, dispatch=dispatch)
    p = carry.params_from_reference(host, device="cpu")
    got, gaux = tT.forward(cfg, p, {"tokens": toks})
    assert got.shape == full.shape and got.dtype == torch.float32
    gaps = {"forward": _gap(got, full)}
    assert float(gaux) > 0 and abs(float(gaux) - aux) <= MOE_TOL
    Sp = toks.shape[1] - 4
    lg, cache = tT.prefill(cfg, p, {"tokens": toks[:, :Sp]},
                           max_len=toks.shape[1])
    gaps["prefill"] = _gap(lg, pre)
    for j, t in enumerate(range(Sp, toks.shape[1])):
        lg, cache = tT.decode_step(cfg, p, cache, toks[:, t:t + 1])
        gaps[f"decode{t}"] = _gap(lg, steps[j])
    print(f"{arch}/{dispatch}: gaps {gaps}, aux {float(gaux)} vs {aux}")
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_consistency_no_drop(arch):
    """The reference's test: with no-drop capacity, prefill then decode
    equals the full forward within 5e-5, on the reference's parameters,
    whose full forward the port's equals."""
    host, toks, full, _, _, _ = _reference_model(arch, "einsum", 8.0)
    _, cfg = _cfgs(arch, capacity_factor=8.0)
    p = carry.params_from_reference(host, device="cpu")
    mine, _ = tT.forward(cfg, p, {"tokens": toks})
    assert _gap(mine, full) <= TOL
    Sp = toks.shape[1] - 4
    lg, cache = tT.prefill(cfg, p, {"tokens": toks[:, :Sp]},
                           max_len=toks.shape[1])
    errs = [_gap(lg[:, 0], mine[:, Sp - 1])]
    for t in range(Sp, toks.shape[1]):
        lg, cache = tT.decode_step(cfg, p, cache, toks[:, t:t + 1])
        errs.append(_gap(lg[:, 0], mine[:, t]))
    assert max(errs) < TOL, errs


def test_a_decode_batch_shares_capacity_as_the_references():
    """Sixteen equal rows of one decode step choose the same two experts,
    and capacity (12 slots an expert at gs = 16) serves the first twelve:
    the port's rows are the reference's, and the rows past the capacity
    are not row 0's.  The engine's idle slots take capacity the same
    way."""
    jax, jnp, _, _, T = _jax()
    rc, cfg = _cfgs("deepseek-moe-16b")
    ref_p, p = _params(rc, 9)
    tok = np.full((16, 1), 3, np.int32)
    want, _ = T.decode_step(rc, ref_p, T.init_cache(rc, 16, 4),
                            jnp.asarray(tok))
    got, _ = tT.decode_step(cfg, p, tT.init_cache(cfg, 16, 4,
                                                  device="cpu"), tok)
    assert _gap(got, want) <= TOL
    rows = _np(got)[:, 0]
    assert (rows[1:12] == rows[0]).all()
    assert (np.abs(rows[12:] - rows[0]).max(-1) > 1e-3).all()
