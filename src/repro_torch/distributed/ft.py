"""Fault tolerance: heartbeats, straggler detection, grain rebalancing, as
``repro/distributed/ft.py`` (pure Python).

At 1000+ nodes the failure model is: slow hosts (stragglers), dead hosts
(restart from checkpoint), and preemptions (emergency save).  This module is
the host-side policy engine; it is exercised by unit tests with injected
clocks and wired into launch/train.py:

* ``Heartbeat``      - per-host liveness files (mtime-based), scale-agnostic;
* ``StragglerMonitor`` - flags steps > k x rolling median; its recommended
  mitigation is the *paper's own knob*: reduce the fetch grain so trailing
  workers steal finer-grained work (SIV-A inverted - average fetching is the
  straggler-tolerant end of the trade-off);
* ``Elastic restart`` - a checkpoint restores onto another mesh through
  checkpoint/ckpt.py (``restore(mesh=)``) + sharding.param_specs; its
  leaves are stored whole.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable


class Heartbeat:
    def __init__(self, directory: str, host_id: int,
                 clock: Callable[[], float] = time.time):
        self.dir = directory
        self.host = host_id
        self.clock = clock
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"host_{host_id}.hb")

    def beat(self):
        with open(self.path, "w") as f:
            f.write(str(self.clock()))

    def dead_hosts(self, timeout: float) -> list[int]:
        now = self.clock()
        dead = []
        for fn in os.listdir(self.dir):
            if not fn.endswith(".hb"):
                continue
            with open(os.path.join(self.dir, fn)) as f:
                try:
                    last = float(f.read().strip())
                except ValueError:
                    last = 0.0
            if now - last > timeout:
                dead.append(int(fn.split("_")[1].split(".")[0]))
        return sorted(dead)


@dataclasses.dataclass
class StragglerReport:
    is_straggler: bool
    step_time: float
    median: float
    recommended_grain_scale: float   # <1: fetch finer grains (paper SIV-A)


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times: deque = deque(maxlen=window)
        self.threshold = threshold

    def record(self, step_time: float) -> StragglerReport:
        med = (sorted(self.times)[len(self.times) // 2]
               if self.times else step_time)
        straggler = len(self.times) >= 4 and step_time > self.threshold * med
        self.times.append(step_time)
        scale = med / step_time if straggler else 1.0
        return StragglerReport(straggler, step_time, med, scale)
