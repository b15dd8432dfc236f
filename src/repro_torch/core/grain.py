"""Coarse-grained fetching policies (paper SIV-A, Fig. 6, Table V).

The paper's runtime amortizes mutex-protected task-queue fetches by executing
``grain`` blocks per fetch:

* **average**:    grain = ceil(grid / pool) -> pool-many fetches, 100 % worker
                  utilization (Fig. 6a);
* **aggressive**: larger grains -> fewer fetches, some workers idle; wins when
                  per-block work is small so fetch overhead dominates
                  (Fig. 6b, Table V: BS/FIR best at grain 8, GA/AES at 1).

Under the port's loop and vector lowerings the "fetch" is one pass of the
Python block loop; the ``cuda`` backend launches every block at once and
ignores the grain, since the card's own block scheduler does the fetching.

``schedule_trace`` reproduces the Fig. 6 schedule analytically and feeds the
scheduling-policy tests and the Table-V benchmark's derived columns.
"""
from __future__ import annotations

import dataclasses
import math

# Per-fetch overhead estimate (instructions-equivalent) used by the heuristic.
# Calibrated so the Table-V crossover (# inst ~ 260k -> grain 8; >= 9M ->
# grain 1..2) is reproduced.
FETCH_OVERHEAD = 200_000.0


def average_grain(grid: int, pool: int) -> int:
    return max(1, math.ceil(grid / pool))


def heuristic_grain(grid: int, pool: int, est_block_work: float) -> int:
    """Paper's heuristic: start from average; go aggressive for short blocks.

    Chooses the grain minimizing   n_fetch * FETCH_OVERHEAD + makespan,
    with makespan = ceil(n_fetch/pool) * grain * est_block_work  (workers run
    whole fetches; idle workers are the aggressive-mode cost).
    """
    best, best_cost = 1, float("inf")
    g = 1
    while g <= grid:
        n_fetch = math.ceil(grid / g)
        waves = math.ceil(n_fetch / pool)
        cost = n_fetch * FETCH_OVERHEAD + waves * g * est_block_work
        if cost < best_cost:
            best, best_cost = g, cost
        g *= 2
    return best


@dataclasses.dataclass
class ScheduleTrace:
    grain: int
    n_fetches: int
    per_worker_blocks: list[int]
    idle_workers: int
    utilization: float


def schedule_trace(grid: int, pool: int, grain: int) -> ScheduleTrace:
    """Analytic re-enactment of Fig. 6's greedy queue schedule."""
    n_fetches = math.ceil(grid / grain)
    worker_load = [0] * pool
    remaining = grid
    for f in range(n_fetches):
        w = min(range(pool), key=lambda i: worker_load[i])
        take = min(grain, remaining)
        worker_load[w] += take
        remaining -= take
    idle = sum(1 for L in worker_load if L == 0)
    makespan = max(worker_load) if worker_load else 0
    util = (grid / (makespan * pool)) if makespan else 1.0
    return ScheduleTrace(grain, n_fetches, worker_load, idle, util)
