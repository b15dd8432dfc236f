"""The port's mesh path at several gloo ranks on the CPU: the reference's
``test_sharded_equals_single_device`` and ``test_elastic_reshard_restore``
(``tests/test_dryrun.py``), the compressed-DP example, and
``launch.train --mesh 2x2``.

Each job spawns its ranks in a child process (never in the pytest
worker, where a default process group would outlive the file) and writes
what the tests read to a JSON file.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

_SHARDED = r"""
import json, os, sys
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp

def run(rank, d):
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=8)
    torch.set_num_threads(1)
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_mod

    cfg = registry.smoke("granite-3-2b").replace(
        d_model=64, num_heads=4, num_kv_heads=2, tp_align=2)
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=1)
    params = T.init_params(cfg, 0, device="cpu")
    opt = adamw.init_state(opt_cfg, params)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32))
             .astype(np.int32)}
    # one device
    p1, o1, m1 = train_mod.make_train_step(cfg, opt_cfg)(params, opt, batch)
    # sharded on a (2 data, 4 model) mesh
    mesh = shd.make_mesh((2, 4), ("data", "model"), device="cpu")
    with shd.use_mesh(mesh):
        ps = shd.shard_params(params, mesh)
        os_ = adamw.AdamWState(opt.step, shd.shard_params(opt.m, mesh),
                               shd.shard_params(opt.v, mesh))
        p2, o2, m2 = train_mod.make_train_step(cfg, opt_cfg)(ps, os_, batch)
    # the backward alone: every gradient leaf, one device against the mesh
    loss = train_mod.make_loss(cfg)
    tokens = torch.as_tensor(batch["tokens"])
    _, g1 = train_mod.value_and_grad(loss, params, {"tokens": tokens})
    with shd.use_mesh(mesh):
        _, g2 = train_mod.value_and_grad(loss, ps, {"tokens": shd.distribute(
            tokens, mesh, shd.batch_placements(mesh, tokens.shape))})
    want = shd.param_placements(params, mesh)
    placed = []
    for tree in (p2, o2.m, o2.v, g2):
        shd.map_with_path(lambda path, t: placed.append(
            isinstance(t, shd.DTensor)
            and tuple(t.placements) == shd.at_path(want, path)), tree)

    def gap(a, b):
        return float((a.float() - shd.full(b).float()).abs().max())

    def rel_gap(t1, t2):
        # the largest gap of a leaf over the leaf's largest magnitude
        return max(gap(a, b) / max(float(a.float().abs().max()), 1e-30)
                   for a, b in zip(adamw.tree_leaves(t1),
                                   adamw.tree_leaves(t2), strict=True))
    err = max(gap(a, b) for a, b in zip(
        adamw.tree_leaves(p1), adamw.tree_leaves(p2), strict=True))
    gaps = {"grad": rel_gap(g1, g2), "m": rel_gap(o1.m, o2.m),
            "v": rel_gap(o1.v, o2.v)}
    loss1, loss2 = float(m1["loss"]), float(shd.full(m2["loss"]))

    # elastic: save on (2, 4), restore onto (2, 2, 2)
    rcfg = registry.smoke("qwen2-0.5b").replace(tp_align=2)
    rparams = T.init_params(rcfg, 0, device="cpu")
    mgr = CheckpointManager(f"{d}/ckpt")
    mgr.save(1, shd.shard_params(rparams, mesh), blocking=True)
    mesh2 = shd.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    r2, _ = mgr.restore(rparams, mesh=mesh2)
    rwant = shd.param_placements(rparams, mesh2)
    rplaced = []
    shd.map_with_path(lambda path, t: rplaced.append(
        tuple(t.placements) == shd.at_path(rwant, path)), r2)
    bits = all(torch.equal(a, shd.full(b)) for a, b in zip(
        adamw.tree_leaves(rparams), adamw.tree_leaves(r2), strict=True))
    if rank == 0:
        with open(f"{d}/out.json", "w") as f:
            json.dump({"loss1": loss1, "loss2": loss2, "err": err,
                       "gaps": gaps,
                       "placed": all(placed), "n_placed": len(placed),
                       "bits": bits, "rplaced": all(rplaced)}, f)
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=8)
"""

_LAUNCH = r"""
import json, sys
import torch, torch.distributed as dist, torch.multiprocessing as mp

ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "3", "--batch", "8",
        "--seq", "16", "--log-every", "1", "--device", "cpu"]

def run(rank, d):
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=4)
    torch.set_num_threads(1)
    from repro_torch.launch import train
    loss = train.main(ARGS + ["--mesh", "2x2"])
    out = {"mesh": loss}
    dist.destroy_process_group()
    if rank == 0:
        out["single"] = train.main(ARGS + ["--mesh", ""])
        with open(f"{d}/out.json", "w") as f:
            json.dump(out, f)

if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1],), nprocs=4)
"""


def _job(script, tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    path = d / "job.py"
    path.write_text(textwrap.dedent(script))
    r = subprocess.run([sys.executable, str(path), str(d)],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    with open(d / "out.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return _job(_SHARDED, tmp_path_factory.mktemp("ranks"), "sharded")


#: the sharded backward's largest gap a leaf, over the leaf's largest
#: magnitude, in the gradients and in AdamW's first and second moments
#: after one step (which carry (1 - b1) clip g and (1 - b2) g^2): 10x the
#: largest measured on the CPU (grad 8.37e-7, m 8.32e-7, v 1.24e-6)
SHARDED_GRAD_REL_TOL = 1.25e-5


def test_sharded_equals_single_device(sharded):
    """8 ranks on a (2, 4) mesh hold the one-device step within the
    reference's bounds (loss 1e-4, parameters 5e-3), and the backward's
    every gradient and moment leaf within ``SHARDED_GRAD_REL_TOL`` of the
    leaf's scale: a first AdamW step moves no parameter by more than about
    lr, so the parameter bound alone would pass any gradient.  Every
    parameter, moment and gradient is a DTensor placed as ``param_specs``
    says."""
    print(f"sharded step: loss gap {abs(sharded['loss1'] - sharded['loss2'])}"
          f" max parameter gap {sharded['err']} relative leaf gaps "
          f"{sharded['gaps']}")
    assert abs(sharded["loss1"] - sharded["loss2"]) < 1e-4, sharded
    assert sharded["err"] < 5e-3, sharded
    for name, g in sharded["gaps"].items():
        assert g <= SHARDED_GRAD_REL_TOL, (name, sharded)
    assert sharded["placed"] and sharded["n_placed"] > 0, sharded


def test_elastic_reshard_restore(sharded):
    """Saved from a (2, 4) mesh, restored onto (2, 2, 2): bit for bit,
    each leaf placed by the rules on the new mesh."""
    assert sharded["bits"] and sharded["rplaced"], sharded


def test_compressed_dp_example_converges():
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "examples", "torch_compressed_dp.py")],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "converged" in r.stdout


def test_launch_train_mesh_2x2_at_4_ranks(tmp_path):
    """``launch.train --mesh 2x2`` at 4 ranks ends where the one-device
    run does."""
    out = _job(_LAUNCH, tmp_path, "launch")
    assert abs(out["mesh"] - out["single"]) < 1e-4, out
