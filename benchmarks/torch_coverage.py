"""Table II of the paper for the PyTorch port: suite coverage per backend.

    PYTHONPATH=src python benchmarks/torch_coverage.py [--device cpu|cuda]

The port's counterpart of ``benchmarks/coverage.py``.  Every entry of
``cuda_suite.build_suite(1)`` runs end to end (a chain through its whole
``LaunchChain``) under every backend of the port's registry, on the card
unless ``--device cpu`` is given, and each cell is ``correct`` (every
written buffer within the entry's oracle tolerance), ``incorrect`` or
``unsupport`` (the backend raised ``UnsupportedKernel``).  The columns
model the paper's frameworks:

  naive        - MCUDA without fission (single-stage kernels only)
  loop_nowarp  - the DPC++/HIP-CPU class (barriers, no warp functions)
  loop         - CuPBoP's loop lowering
  vector       - the vectorised lowering
  cuda         - the hand-written Hopper kernels (where the reference
                 has its Pallas emission)
  shard        - the loop lowering's blocks over a pool of workers
  shard_vector - the vectorised lowering's blocks over the pool

The shard columns run at the pool the environment gives
(``CUPBOP_HOST_DEVICES`` host workers on the CPU, the cards on CUDA).
The paper's headline is CuPBoP 69.6 % against 56.6 % for the best prior
translator on Rodinia.  The percentages here are over the suite's 23
kernels, so the ordering is the claim: naive < loop_nowarp < loop ==
vector == cuda.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch.core import UnsupportedKernel, backend_names  # noqa: E402
from repro_torch.core.cuda_suite import build_suite, run_entry  # noqa: E402
from repro_torch.core.memory import host_array  # noqa: E402

#: the paper's Table II Rodinia coverage: CuPBoP against the best prior
#: CUDA-on-CPU translator (DPC++)
PAPER_CUPBOP_PCT = 69.6
PAPER_PRIOR_PCT = 56.6


def frameworks() -> tuple[str, ...]:
    """Columns come from the live backend registry, not a frozen tuple."""
    return backend_names()


def percentages(table: dict) -> dict[str, float]:
    """Paper-style coverage percentage per framework: ``correct`` cells
    count for it, ``unsupport`` and ``incorrect`` cells against it."""
    if not table:
        return {fw: 0.0 for fw in frameworks()}
    fws = next(iter(table.values()))[0].keys()
    return {fw: 100.0 * sum(row[fw] == "correct"
                            for row, _ in table.values()) / len(table)
            for fw in fws}


def run(device=None, seconds: dict | None = None,
        backends: tuple[str, ...] | None = None) -> dict:
    """``{kernel: ({framework: status}, features)}`` over
    ``build_suite(1)`` on ``device``, for ``backends`` (every registered
    one by default); adds each framework's wall to ``seconds`` when a
    dict is given."""
    fws = frameworks() if backends is None else backends
    table = {}
    for e in build_suite(scale=1):
        row = {}
        for fw in fws:
            t0 = time.perf_counter()
            try:
                out, want = run_entry(e, fw, rng=np.random.default_rng(0),
                                      device=device)
                tol = max(e.tol, 2e-5)
                ok = all(np.allclose(host_array(out[k]), v, rtol=tol,
                                     atol=tol)
                         for k, v in want.items())
                row[fw] = "correct" if ok else "incorrect"
            except UnsupportedKernel:
                row[fw] = "unsupport"
            if seconds is not None:
                seconds[fw] = seconds.get(fw, 0.0) + time.perf_counter() - t0
        table[e.name] = (row, e.features)
    return table


def counts(table: dict) -> dict[str, int]:
    """Correct kernels per framework."""
    fws = next(iter(table.values()))[0].keys() if table else frameworks()
    return {fw: sum(row[fw] == "correct" for row, _ in table.values())
            for fw in fws}


def ordering_holds(cov: dict[str, int]) -> bool:
    """The paper's ordering: naive < loop_nowarp < loop == vector == cuda."""
    return (cov["naive"] < cov["loop_nowarp"] < cov["loop"]
            == cov["vector"] == cov["cuda"])


def paper_line(pct: dict[str, float]) -> str:
    return (f"paper_figures,CuPBoP {PAPER_CUPBOP_PCT}% vs prior "
            f"{PAPER_PRIOR_PCT}% on Rodinia; here "
            + " ".join(f"{fw} {p:.1f}%" for fw, p in pct.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    seconds: dict[str, float] = {}
    table = run(args.device, seconds)
    names = sorted(table)
    fws = frameworks()
    print("kernel," + ",".join(fws) + ",features")
    for n in names:
        row, feats = table[n]
        print(n + "," + ",".join(row[f] for f in fws)
              + "," + "|".join(feats))
    print()
    pct = percentages(table)
    for fw in fws:
        print(f"coverage_{fw},{pct[fw]:.1f},%,"
              f"seconds={seconds.get(fw, 0.0):.2f}")
    print(paper_line(pct))
    if not ordering_holds(counts(table)):
        print("paper_ordering,0,naive<nowarp<cupbop does NOT hold",
              file=sys.stderr)
        return 1
    print("paper_ordering,1,naive<nowarp<loop==vector==cuda "
          "(Table II reproduced)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
