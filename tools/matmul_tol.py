#!/usr/bin/env python3
"""Derive matmul_tiled's oracle tolerance on the CPU.

    PYTHONPATH=src python tools/matmul_tol.py

Runs the port's plain version of matmul_tiled (8-deep k-tiles added into
a float32 accumulator) on seeded float32 inputs at m = n = 2048 and depth
k = 32, 128, 512, 2048, and prints its worst error against the float64
product of the same inputs and against NumPy's float32 product (the
entry's oracle), in ``allclose``'s measure ``|got - want| / (1 + |want|)``,
beside ``cuda_suite.matmul_tol(k)``.  The tolerance must stay above both
with room for the card's order of additions inside a tile.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cuda_suite, lower_cuda
from repro_torch.core.dim3 import Dim3


def worst(got: np.ndarray, want: np.ndarray) -> float:
    return float((np.abs(got - want) / (1.0 + np.abs(want))).max())


def main(size: int = 2048, depths=(32, 128, 512, 2048)) -> None:
    for k in depths:
        entry = cuda_suite.entry_matmul_tiled(size, size, k)
        args = entry.make_args(np.random.default_rng(42))
        bufs = {n: torch.from_numpy(v) for n, v in args.items()}
        got = lower_cuda.matmul_tiled_plain(
            bufs, Dim3(entry.grid), Dim3(entry.block),
            **dict(entry.kernel.native.params))["c"].numpy()
        exact = args["a"].astype(np.float64) @ args["b"].astype(np.float64)
        oracle = entry.reference(args)["c"]
        print(f"m=n={size} k={k}: worst vs float64 "
              f"{worst(got, exact):.3e}, vs the float32 oracle "
              f"{worst(got, oracle):.3e}, oracle vs float64 "
              f"{worst(oracle, exact):.3e}, matmul_tol "
              f"{cuda_suite.matmul_tol(k):.3e}")


if __name__ == "__main__":
    main()
