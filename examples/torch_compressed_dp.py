"""Cross-pod data parallelism with int8 + error-feedback gradient
compression, in the PyTorch port: ``examples/compressed_dp.py`` over c10d.

Four gloo ranks on the CPU stand in for four pods: each computes its
pod's gradient of a toy linear regression, ``compressed_psum`` quantizes
it to int8, sums over the group, dequantizes, and each rank keeps its
quantization residual for the next step.  Run:

  PYTHONPATH=src python examples/torch_compressed_dp.py
"""
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum, dcn_bytes)

PODS = 4
LR, STEPS = 0.25, 600


def run(rank: int, store: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=PODS)
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((64, 16)).astype(np.float32)
    X = rng.standard_normal((PODS * 32, 64)).astype(np.float32)
    Y = X @ w_true
    x = torch.from_numpy(X[rank * 32:(rank + 1) * 32])
    y = torch.from_numpy(Y[rank * 32:(rank + 1) * 32])
    w = torch.zeros(64, 16)
    err = torch.zeros_like(w)
    for _ in range(STEPS):
        wg = w.clone().requires_grad_()
        loss = torch.mean((x @ wg - y) ** 2)
        (g,) = torch.autograd.grad(loss, wg)
        g_red, e_new = compressed_psum({"w": g}, dist.group.WORLD,
                                       {"w": err})
        w, err = w - LR * g_red["w"], e_new["w"]
    if rank == 0:
        final = float(torch.mean((torch.from_numpy(X) @ w
                                  - torch.from_numpy(Y)) ** 2))
        with open(out, "w") as f:
            f.write(repr(final))
    dist.destroy_process_group()


def main() -> None:
    d = tempfile.mkdtemp()
    out = os.path.join(d, "final")
    mp.spawn(run, args=(os.path.join(d, "store"), out), nprocs=PODS)
    with open(out) as f:
        final = float(f.read())
    comp, full = dcn_bytes({"w": torch.zeros(64, 16)})
    print(f"final mse {final:.5f} (int8+EF converged) "
          f"dcn bytes/step {comp} vs fp32 {full} ({full / comp:.1f}x saved)")
    assert final < 0.1, final   # int8 noise floor at fixed lr


if __name__ == "__main__":
    main()
