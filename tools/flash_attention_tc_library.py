#!/usr/bin/env python3
"""Time ``scaled_dot_product_attention`` beside the "tc" flash prefill.

    PYTHONPATH=src python tools/flash_attention_tc_library.py   # a CUDA card

At tools/flash_attention_tc_variants.cu's five causal bfloat16 shapes
(granite-3-2b's attention at train_4k, qwen2-0.5b's training step with
lse, deepseek-moe-16b's and zamba2-7b's 1,024-token prefills, a 32,768-token
prompt), on seeded standard-normal inputs, it prints PyTorch's fused
attention (``is_causal=True, enable_gqa=True``; the library call the
kernel is measured against, never called by the port) and the port's
``ops.flash_attention`` (the launcher with its three tensor-map encodes a
call, then the kernel): each the median of 25 CUDA-event runs after 2
warm-ups, each run behind a spin on the card that covers the host's
enqueue, in three turns (their medians and the median of the three).
"""
from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

#: (name, B, H, Hkv, S, d, with_lse), as the variants tool's
SHAPES = [("hot", 2, 32, 8, 4096, 64, False),
          ("train", 4, 16, 16, 1024, 64, True),
          ("moe", 1, 16, 16, 1024, 128, False),
          ("zamba2", 1, 32, 32, 1024, 112, False),
          ("long", 1, 32, 8, 32768, 64, False)]
TURNS, RUNS, WARMUP = 3, 25, 2
SPIN_CYCLES = 200_000


def time_ms(fn) -> float:
    times = []
    for i in range(WARMUP + RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= WARMUP:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def calls(q, k, v, lse: bool) -> dict:
    """The library call and the port's, on the same tensors."""
    S = q.shape[2]
    return {
        "sdpa": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        "ops": lambda: ops.flash_attention(q, k, v, causal=True, q_blk=S,
                                           kv_blk=S, with_lse=lse)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_tc_library: needs a CUDA card")
    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}")
    gen = torch.Generator().manual_seed(0)
    for name, B, H, Hkv, S, d, lse in SHAPES:
        q, k, v = (torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
                   for s in ((B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)))
        assert tfa.route(q, k, v) == "tc"
        fns = calls(q, k, v, lse)
        turns = {c: [] for c in fns}
        for _ in range(TURNS):
            for c, fn in fns.items():
                turns[c].append(time_ms(fn))
        for c, ts in turns.items():
            print(f"shape {name} (B {B}, H {H}, Hkv {Hkv}, S {S}, d {d}"
                  f"{', lse' if lse else ''}) {c}: "
                  f"ms={statistics.median(ts):.5f} turns="
                  + "/".join(f"{t:.5f}" for t in ts), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
