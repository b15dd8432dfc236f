#!/usr/bin/env python3
"""Time PyTorch's calls beside the decode kernel and rmsnorm's wide path.

    PYTHONPATH=src python tools/decode_rmsnorm_library.py   # a CUDA card

On seeded standard-normal inputs, at tools/flash_decode_variants.cu's
decode shapes (the hot path's B 32, H 32, Hkv 8 over 4,096 keys at d 64
in bfloat16 and float32; deepseek-moe-16b's 16 heads of 128 and
zamba2-7b's 32 heads of 112 over 1,024 keys; qwen2-0.5b's 16 heads of 64
over 1,024 keys, one slot and four) it prints the port's
``ops.flash_attention`` (its route must be ``"decode"``) beside
``scaled_dot_product_attention`` (``is_causal=False, enable_gqa=True``);
at tools/rmsnorm_variants.cu's wide rows (``[1024, 7168]`` and
``[4, 7168]`` float32, ``[1024, 8192]`` and ``[4096, 5120]`` bfloat16, x
and scale of one dtype) the port's ``ops.rmsnorm`` beside
``F.rms_norm`` with the weight ``1 + scale``.  The library calls are the
yardsticks the kernels are measured against; the port never calls them.
Each is the median of 25 CUDA-event runs after 2 warm-ups, each run
behind a spin on the card that covers the host's enqueue, in three turns
(their medians and the median of the three), beside the bound: the bytes
read once and written once over 3.35 TB/s.
"""
from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

#: (name, B, H, Hkv, Skv, d, dtype)
DECODE = [("hot", 32, 32, 8, 4096, 64, torch.bfloat16),
          ("hot", 32, 32, 8, 4096, 64, torch.float32),
          ("d128_moe", 1, 16, 16, 1024, 128, torch.bfloat16),
          ("d112_zamba2", 1, 32, 32, 1024, 112, torch.bfloat16),
          ("qwen2_1slot", 1, 16, 16, 1024, 64, torch.bfloat16),
          ("qwen2_4slots", 4, 16, 16, 1024, 64, torch.bfloat16)]
#: (rows, d, dtype)
RMSNORM = [(1024, 7168, torch.float32), (4, 7168, torch.float32),
           (1024, 8192, torch.bfloat16), (4096, 5120, torch.bfloat16)]
TURNS, RUNS, WARMUP = 3, 25, 2
SPIN_CYCLES = 200_000
HBM_BYTES_PER_S = 3.35e12


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


def report(label: str, fns: dict, nbytes: int) -> None:
    turns = {c: [] for c in fns}
    for _ in range(TURNS):
        for c, fn in fns.items():
            turns[c].append(time_ms(fn))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    for c, ts in turns.items():
        print(f"{label} {c}: ms={statistics.median(ts):.5f} turns="
              + "/".join(f"{t:.5f}" for t in ts)
              + f" bound_ms={bound:.5f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_rmsnorm_library: needs a CUDA card")
    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(0)}")
    gen = torch.Generator().manual_seed(0)
    for name, B, H, Hkv, Skv, d, dt in DECODE:
        q, k, v = (torch.randn(*s, generator=gen).to(dev, dt)
                   for s in ((B, H, 1, d), (B, Hkv, Skv, d),
                             (B, Hkv, Skv, d)))
        assert tfa.route(q, k, v) == "decode"
        parts, per = tfa.decode_split(B, Hkv, Skv, dt, d)
        size = q.element_size()
        report(f"decode {name} {str(dt).removeprefix('torch.')} (B {B}, "
               f"H {H}, Hkv {Hkv}, Skv {Skv}, d {d}; parts {parts}, "
               f"per {per})",
               {"sdpa": lambda: F.scaled_dot_product_attention(
                   q, k, v, enable_gqa=True),
                "ops": lambda: ops.flash_attention(q, k, v, causal=False,
                                                   q_blk=1, kv_blk=Skv)},
               size * (2 * B * H * d + 2 * B * Hkv * Skv * d))
        del q, k, v
        torch.cuda.empty_cache()
    for rows, d, dt in RMSNORM:
        x = torch.randn(rows, d, generator=gen).to(dev, dt)
        scale = torch.randn(d, generator=gen).to(dev, dt)
        w = (1.0 + scale).to(dt)
        report(f"rmsnorm [{rows}, {d}] {str(dt).removeprefix('torch.')}",
               {"rms_norm": lambda: F.rms_norm(x, (d,), weight=w, eps=1e-5),
                "ops": lambda: ops.rmsnorm(x, scale)},
               x.element_size() * 2 * rows * d + scale.element_size() * d)
        del x, scale
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
