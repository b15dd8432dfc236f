"""``python -m repro_torch.launch.train`` on the CPU: the training loop
checkpoints, resumes and stops as the reference's does.

``tests/test_system.py::test_train_resume_exact``'s counterpart, made
exact: a run cut at step 6 and resumed to 10 restores the parameters and
optimizer state the first run ended with, bit for bit, and resumes the
data stream at the saved step.  Also the emergency save on SIGTERM, a
mesh larger than the world and the command line.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "4", "--seq", "32",
        "--ckpt-every", "3", "--log-every", "100", "--device", "cpu"]


def _recording(monkeypatch, on_step=None):
    """Wrap ``launch.train``'s step so each call's batch and result are
    kept."""
    seen = []
    real = tstep.make_train_step

    def make(*a, **k):
        fn = real(*a, **k)

        def step(params, opt, batch):
            out = fn(params, opt, batch)
            seen.append((batch, out))
            if on_step is not None:
                on_step(len(seen))
            return out
        return step

    monkeypatch.setattr(tstep, "make_train_step", make)
    return seen


def _leaves(state):
    params, opt = state
    return (tadam.tree_leaves(params) + [opt.step]
            + tadam.tree_leaves(opt.m) + tadam.tree_leaves(opt.v))


def test_train_resume_exact(tmp_path, monkeypatch, capsys):
    ck = str(tmp_path / "ck")
    first = _recording(monkeypatch)
    tlaunch.main(ARGS + ["--ckpt-dir", ck, "--steps", "6"])   # "crash" at 6
    assert sorted(os.listdir(ck)) == ["step_00000003", "step_00000006"]
    end = first[-1][1][:2]                 # (params, opt) after step 6

    restored = []
    real_restore = CheckpointManager.restore

    def restore(self, template, step=None, mesh=None):
        out = real_restore(self, template, step, mesh)
        restored.append(out)
        return out

    monkeypatch.setattr(CheckpointManager, "restore", restore)
    second = _recording(monkeypatch)
    loss = tlaunch.main(ARGS + ["--ckpt-dir", ck, "--steps", "10"])
    assert np.isfinite(loss) and len(second) == 4
    assert "[resume] restored step 6 (data stream at 6)" in \
        capsys.readouterr().out
    (state, extra), = restored
    assert extra == {"data_step": 6}
    got, want = _leaves(state), _leaves(end)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    cfg = treg.smoke("qwen2-0.5b")
    data = SyntheticLM(cfg.vocab_size, 32, 4)
    for i, (batch, _) in enumerate(second):
        assert np.array_equal(batch["tokens"],
                              data.batch_at(6 + i)["tokens"])
    assert int(second[-1][1][1].step) == 10
    assert CheckpointManager(ck).latest_valid() == 9


def test_sigterm_saves_an_emergency_checkpoint_and_stops(tmp_path,
                                                         monkeypatch):
    ck = str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGTERM)

    def preempt(n):
        if n == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    seen = _recording(monkeypatch, on_step=preempt)
    tlaunch.main(ARGS + ["--ckpt-dir", ck, "--steps", "8",
                         "--ckpt-every", "50"])
    assert len(seen) == 2                       # stopped after step 1
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2]
    params, opt = seen[-1][1][:2]
    (p2, o2), extra = mgr.restore((params, opt))
    assert extra == {"data_step": 2} and int(o2.step) == 2
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves((p2, o2)), _leaves((params, opt)),
                   strict=True))
    assert signal.getsignal(signal.SIGTERM) is before


def test_a_mesh_is_refused_naming_the_roadmap():
    """A mesh larger than the world is refused, naming its ranks, before
    any process group starts (``--mesh 2x2`` runs at 4 ranks in
    ``test_torch_distributed_ranks.py``)."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match=r"needs a process group of 4 "
                                           r"ranks, have 1"):
        tlaunch.main(ARGS + ["--mesh", "2x2", "--steps", "1"])
    assert not dist.is_initialized()


def test_train_command_runs_with_microbatches():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-2b", "--smoke", "--steps", "3", "--batch", "4", "--seq",
         "16", "--microbatches", "2", "--log-every", "1", "--device", "cpu",
         "--mesh", "1x1"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 3 and "loss" in lines[-1] and "gnorm" in lines[-1]
