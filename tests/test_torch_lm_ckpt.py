"""The port's data pipeline, checkpoints and fault-tolerance monitors
against the reference's, on the CPU.

``SyntheticLM`` and ``TextFileLM`` give the reference's batches bit for
bit; ``CheckpointManager`` keeps the reference's layout (leaf names,
files, manifest), so a checkpoint the reference wrote restores in the port
and its next train step gives the reference's loss within 1e-5; and the
reference's ``tests/test_distributed.py`` cases of ``ckpt``, the pipeline,
``StragglerMonitor`` and ``Heartbeat`` run on the port.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher, SyntheticLM,  # noqa: E402
                                       TextFileLM)
from repro_torch.distributed.ft import Heartbeat, StragglerMonitor  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_lm_models import _toks  # noqa: E402


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import ckpt
    from repro.configs import registry
    from repro.data import pipeline
    from repro.models import transformer
    from repro.optim import adamw
    from repro.train import step
    return jax, jnp, ckpt, registry, pipeline, transformer, adamw, step


# ---- data ---------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(seed=3, rank=1, world=2),
                                dict(num_codebooks=4)])
def test_synthetic_batches_are_the_references_bit_for_bit(kw):
    ref = _jax()[4].SyntheticLM(1000, 16, 8, **kw)
    mine = SyntheticLM(1000, 16, 8, **kw)
    assert mine.local_batch == ref.local_batch
    for s in (0, 5, 123):
        a, b = mine.batch_at(s)["tokens"], ref.batch_at(s)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert mine.state(s) == ref.state(s)


def test_textfile_batches_are_the_references_bit_for_bit(tmp_path):
    f = tmp_path / "corpus.txt"
    f.write_text("hello world, this is a tiny corpus for byte-level lm " * 40)
    ref = _jax()[4].TextFileLM(str(f), seq_len=16, global_batch=4, rank=1,
                               world=2)
    mine = TextFileLM(str(f), seq_len=16, global_batch=4, rank=1, world=2)
    for s in (0, 7):
        assert np.array_equal(mine.batch_at(s)["tokens"],
                              ref.batch_at(s)["tokens"])
    b = TextFileLM(str(f), seq_len=16, global_batch=4).batch_at(0)
    assert b["tokens"].shape == (4, 16)


def test_synthetic_seekable_and_rank_sharded():
    d = SyntheticLM(1000, 16, 8)
    b1, b2 = d.batch_at(5), d.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d.batch_at(5)["tokens"],
                              d.batch_at(6)["tokens"])
    assert b1["tokens"].max() < 1000 and b1["tokens"].min() >= 0
    r0 = SyntheticLM(1000, 16, 8, rank=0, world=2)
    r1 = SyntheticLM(1000, 16, 8, rank=1, world=2)
    assert r0.local_batch == 4
    assert not np.array_equal(r0.batch_at(0)["tokens"],
                              r1.batch_at(0)["tokens"])


def test_prefetcher_resume():
    d = SyntheticLM(1000, 8, 4)
    p = Prefetcher(d, start_step=3)
    for want in (3, 4):
        s, b = p.next()
        assert s == want
        np.testing.assert_array_equal(b["tokens"], d.batch_at(want)["tokens"])
    p.close()


# ---- checkpoints --------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype("f")),
            "opt": {"m": torch.zeros(8, 4),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "h": torch.from_numpy(rng.standard_normal(6).astype("f")
                                  ).bfloat16()}


def _zeros_like(tree):
    return tadam.tree_map(torch.zeros_like, tree)


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(10, t, extra={"data_step": 11}, blocking=True)
    out, extra = mgr.restore(_zeros_like(t))
    assert extra["data_step"] == 11
    assert torch.equal(out["w"], t["w"]) and int(out["opt"]["step"]) == 7
    assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"], t["h"])
    with open(tmp_path / "step_00000010" / "manifest.json") as f:
        meta = json.load(f)["leaves"]
    assert meta["h"]["dtype"] == "bfloat16" and meta["h"]["shape"] == [6]
    assert meta["opt_step"]["dtype"] == "int32"


def test_ckpt_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_valid() == 3


def test_ckpt_corruption_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1), blocking=True)
    mgr.save(2, _tree(2), blocking=True)
    path = os.path.join(str(tmp_path), "step_00000002", "w.npy")
    with open(path, "wb") as f:
        f.write(b"garbage")
    assert mgr.latest_valid() == 1          # falls back to the older one
    out, _ = mgr.restore(_zeros_like(_tree()))
    assert torch.equal(out["w"], _tree(1)["w"])
    with pytest.raises(IOError):
        mgr.restore(_zeros_like(_tree()), step=2)
    with pytest.raises(NotImplementedError, match=r"1\.14\.5"):
        mgr.restore(_zeros_like(_tree()), mesh=object())


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """One reference train step of qwen2-0.5b's smoke model, saved by the
    reference's CheckpointManager, and the reference's next step."""
    jax, jnp, ckpt, reg, _, T, adamw, step = _jax()
    cfg = reg.smoke("qwen2-0.5b")
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    opt = adamw.init_state(opt_cfg, params)
    fn = jax.jit(step.make_train_step(cfg, opt_cfg))
    b0 = {"tokens": _toks(cfg, 2, 16, seed=0)}
    b1 = {"tokens": _toks(cfg, 2, 16, seed=1)}
    params, opt, _ = fn(params, opt, b0)
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    ref_mgr = ckpt.CheckpointManager(d)
    ref_mgr.save(1, (params, opt), extra={"data_step": 1}, blocking=True)
    names = [n for n, _ in ckpt._leaf_paths((params, opt))]
    _, _, m = fn(params, opt, b1)
    return d, names, float(m["loss"]), b1


def test_leaf_names_are_the_references(reference_run):
    _, names, _, _ = reference_run
    cfg = treg.smoke("qwen2-0.5b")
    from repro_torch.models import transformer as tT
    params = tT.init_params(cfg, 0, device="cpu")
    opt = tadam.init_state(tadam.AdamWConfig(), params)
    mine = [n for n, _ in tckpt._leaf_paths((params, opt))]
    assert sorted(mine) == sorted(names)
    assert "0_embed_tok" in mine and "1_.step" in mine
    assert "1_.m_embed_tok" in mine and "1_.v_layers_attn_wq" in mine


def test_a_reference_checkpoint_resumes_in_the_port(reference_run):
    d, _, want, b1 = reference_run
    from repro_torch.models import transformer as tT
    cfg = treg.smoke("qwen2-0.5b")
    opt_cfg = tadam.AdamWConfig(total_steps=10, warmup_steps=2)
    params = tT.init_params(cfg, 9, device="cpu")      # overwritten
    opt = tadam.init_state(opt_cfg, params)
    mgr = CheckpointManager(d)
    assert mgr.latest_valid() == 1
    (params, opt), extra = mgr.restore((params, opt))
    assert extra == {"data_step": 1} and int(opt.step) == 1
    _, _, m = tstep.train_step(cfg, opt_cfg, params, opt, b1)
    assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want)


def test_a_port_checkpoint_has_the_references_layout(tmp_path):
    """What the port writes, the reference's manager validates and
    restores (float32 leaves), with the same hashes."""
    _, _, ckpt, *_ = _jax()
    t = _tree(4)
    CheckpointManager(str(tmp_path)).save(3, t, extra={"data_step": 4},
                                          blocking=True)
    ref_mgr = ckpt.CheckpointManager(str(tmp_path))
    assert ref_mgr.latest_valid() == 3
    tmpl = {"w": np.zeros((8, 4), np.float32),
            "opt": {"m": np.zeros((8, 4), np.float32),
                    "step": np.int32(0)}}
    out, extra = ref_mgr.restore(tmpl)
    assert extra == {"data_step": 4}
    assert np.array_equal(np.asarray(out["w"]), t["w"].numpy())
    assert int(out["opt"]["step"]) == 7


# ---- fault tolerance ------------------------------------------------------
def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0)
    for _ in range(8):
        rep = mon.record(1.0)
    assert not rep.is_straggler
    rep = mon.record(5.0)
    assert rep.is_straggler and rep.recommended_grain_scale < 0.5


def test_heartbeat_dead_hosts(tmp_path):
    clock = {"t": 100.0}
    hb0 = Heartbeat(str(tmp_path), 0, clock=lambda: clock["t"])
    hb1 = Heartbeat(str(tmp_path), 1, clock=lambda: clock["t"])
    hb0.beat()
    hb1.beat()
    assert hb0.dead_hosts(timeout=10) == []
    clock["t"] = 120.0
    hb0.beat()
    assert hb0.dead_hosts(timeout=10) == [1]
