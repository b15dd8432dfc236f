#!/usr/bin/env python3
"""Measure how far each flash attention kernel lands from its plain version.

    PYTHONPATH=src python tools/flash_plain_err.py      # needs a CUDA card

Runs each of ``flash_attention.route``'s three kernels through
``ops.flash_attention`` on the shapes of the ``gpu`` tests and of
``chip_smoke.py`` (seeded standard-normal inputs, seeds 7, 8 and 9), and
the kernel's plain version (``flash_attention.plain``) on the same
tensors.  For each route and dtype it prints the worst of

* ``abs``: ``|got - want|``;
* ``ulps``: that difference in ulps of the larger of the two (bfloat16
  or float32 ulps);
* ``atol@rtol``: the least ``atol`` that ``allclose(got, want, rtol, atol)``
  needs at the route's ``PLAIN_TOL`` rtol,

beside ``flash_attention.PLAIN_TOL``, which must stay above them with room
for other inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

#: (B, H, Hkv, Sq, Skv, d, causal): tests/test_kernels.py's flash sweep,
#: the tensor-core prefill and decode tests' extra shapes,
#: chip_smoke.py's granite-3-2b prefill and decode, and the decode
#: kernel's cluster cases
SHAPES = [(1, 4, 4, 128, 128, 64, True), (2, 8, 2, 256, 256, 64, True),
          (1, 4, 1, 64, 256, 128, False), (2, 2, 2, 1, 128, 64, False),
          (1, 6, 3, 96, 96, 32, True),
          (1, 4, 1, 100, 300, 64, True), (1, 4, 1, 300, 100, 64, True),
          (2, 4, 2, 128, 128, 32, True), (2, 4, 2, 128, 128, 64, False),
          (1, 4, 1, 80, 70, 80, True), (1, 4, 1, 80, 70, 128, True),
          (1, 4, 1, 80, 70, 20, True), (1, 4, 1, 80, 70, 20, False),
          (2, 8, 2, 1, 1, 64, False), (2, 8, 2, 1, 1000, 64, False),
          (1, 8, 2, 1, 4096, 64, False), (2, 4, 1, 1, 300, 128, False),
          (2, 8, 2, 2, 777, 64, True), (32, 32, 8, 1, 4096, 64, False),
          (1, 8, 1, 1, 500, 80, True), (2, 8, 2, 2, 128, 32, True),
          (2, 32, 8, 4096, 4096, 64, True),
          # decode over few keys and several cluster ranks, where each
          # key's p weighs most; the LM path's decode shapes
          (2, 2, 1, 1, 31, 64, False), (1, 3, 1, 1, 129, 32, False),
          (1, 4, 1, 2, 129, 64, True), (1, 6, 1, 1, 129, 112, False),
          (1, 8, 1, 1, 4097, 64, False), (1, 16, 16, 1, 1024, 128, False),
          (1, 32, 32, 1, 1024, 112, False), (4, 16, 16, 1, 1024, 64, False)]
SEEDS = (7, 8, 9)


def offset_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a view that starts one element past a 16-byte
    boundary (the simt route's bfloat16 case)."""
    base = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = base[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def measure(got: torch.Tensor, want: torch.Tensor, rtol: float):
    bits = 7 if want.dtype == torch.bfloat16 else 23    # stored mantissa
    got, want = got.double(), want.double()
    err = (got - want).abs()
    top = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - bits)
    return (float(err.max()), float((err / ulp).max()),
            float((err - rtol * want.abs()).clamp(min=0).max()))


def main() -> None:
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    worst = {}
    for B, H, Hkv, Sq, Skv, d, causal in SHAPES:
        for seed in SEEDS:
            rng = np.random.default_rng(seed)
            arrays = [rng.standard_normal(s).astype(np.float32) for s in
                      ((B, H, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))]
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = (torch.from_numpy(a).to(dev).to(dtype)
                           for a in arrays)
                variants = [(q, k, v)]
                if dtype == torch.bfloat16:    # the same call, unaligned
                    variants.append((offset_copy(q), k, v))
                for qq, kk, vv in variants:
                    which = tfa.route(qq, kk, vv)
                    rtol, _ = tfa.PLAIN_TOL[which, dtype]
                    kw = dict(causal=causal, q_blk=Sq, kv_blk=Skv)
                    got = ops.flash_attention(qq, kk, vv, mode="cuda", **kw)
                    want = tfa.plain(qq, kk, vv, **kw)
                    m = measure(got, want, rtol)
                    key = which, dtype
                    worst[key] = tuple(map(max, zip(worst.get(key, m), m)))
                    shape = (B, H, Hkv, Sq, Skv, d)
                    print(f"{which:6} {str(dtype):14} {shape} "
                          f"causal={causal} seed={seed}: abs={m[0]:.3e} "
                          f"ulps={m[1]:.2f} atol@rtol={m[2]:.3e}")
                    del got, want
            torch.cuda.empty_cache()
    for (which, dtype), m in sorted(worst.items(), key=str):
        print(f"worst {which} {dtype}: abs={m[0]:.3e} ulps={m[1]:.2f} "
              f"atol@rtol={m[2]:.3e}; PLAIN_TOL (rtol, atol) = "
              f"{tfa.PLAIN_TOL[which, dtype]}")


if __name__ == "__main__":
    main()
