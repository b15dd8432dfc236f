"""GQA head padding for fixed-mesh tensor parallelism, as
``repro/models/padding.py`` (pure Python, copied whole).

The production mesh pins TP = 16, but several assigned archs have head counts
that do not divide 16 (qwen2.5: 40q/8kv, minicpm: 36/36, qwen2-0.5b: 14/2,
musicgen: 24/24).  We pad heads so that both the query- and kv-head axes are
multiples of the TP degree while preserving the *exact* original attention
function (verified by tests/test_models.py's padding cases):

* scheme A (duplicate): each kv head is duplicated ``d`` times (smallest d
  with (Hkv*d) % align == 0) and its query group of r = Hq/Hkv heads is split
  across the duplicates (group g_p = ceil(r/d), dummy q slots where r doesn't
  fill);
* scheme B (dummy-pad): append whole dummy (kv + q-group) pairs until
  Hkv % align == 0.

We pick whichever yields fewer padded q heads (q FLOPs dominate).  Dummy q
heads are masked at the attention output so they stay exactly zero through
training (their wq/wo gradients vanish).  The padding overhead is visible in
the roofline MODEL_FLOPS/HLO_FLOPS ratio by construction.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PadPlan:
    hq: int
    hkv: int
    hq_p: int
    hkv_p: int
    group_p: int                 # padded q heads per padded kv head
    qmap: tuple[int, ...]        # [hq_p] -> original q head or -1 (dummy)
    kvmap: tuple[int, ...]       # [hkv_p] -> original kv head or -1 (dummy)

    @property
    def is_identity(self) -> bool:
        return self.hq_p == self.hq and self.hkv_p == self.hkv

    @property
    def head_mask(self) -> tuple[int, ...]:
        return tuple(1 if m >= 0 else 0 for m in self.qmap)


def gqa_pad_plan(hq: int, hkv: int, align: int) -> PadPlan:
    if hq % hkv != 0:
        raise ValueError(f"non-uniform GQA ({hq=}, {hkv=}) unsupported")
    r = hq // hkv
    if align <= 1 or (hq % align == 0 and hkv % align == 0):
        qmap = tuple(range(hq))
        return PadPlan(hq, hkv, hq, hkv, r, qmap, tuple(range(hkv)))

    # scheme A: duplicate kv heads
    d = 1
    while (hkv * d) % align != 0:
        d += 1
    g_a = math.ceil(r / d)
    hq_a, hkv_a = hkv * d * g_a, hkv * d

    # scheme B: dummy-pad kv heads
    hkv_b = math.ceil(hkv / align) * align
    hq_b = hkv_b * r

    if (hq_a, hkv_a) <= (hq_b, hkv_b):
        hq_p, hkv_p, g_p = hq_a, hkv_a, g_a
        kvmap = tuple(j // d for j in range(hkv_p))
        qmap = []
        for j in range(hkv_p):
            base, dup = j // d, j % d
            for k in range(g_p):
                q = r * base + dup * g_p + k
                qmap.append(q if dup * g_p + k < r else -1)
        qmap = tuple(qmap)
    else:
        hq_p, hkv_p, g_p = hq_b, hkv_b, r
        kvmap = tuple(j if j < hkv else -1 for j in range(hkv_p))
        qmap = tuple(
            (r * j + k if j < hkv else -1)
            for j in range(hkv_p) for k in range(r)
        )
    assert len(qmap) == hq_p and len(kvmap) == hkv_p
    assert hq_p % align == 0 and hkv_p % align == 0
    return PadPlan(hq, hkv, hq_p, hkv_p, g_p, qmap, kvmap)
