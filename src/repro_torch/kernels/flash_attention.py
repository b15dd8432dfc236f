"""Flash attention (causal or not, GQA): a hand-written Hopper kernel.

The counterpart of ``repro/kernels/flash_attention.py``: softmax attention
of ``q[B, H, Sq, d]`` over ``k, v[B, Hkv, Skv, d]``, query head ``h``
reading kv head ``h // (H // Hkv)``, with an online softmax whose running
maximum, denominator and accumulator are float32.  The causal mask is
top-left (``qpos >= kpos``, both counted from 0).  The wrapper keeps the
reference's tile arguments, clamps and refusals (``Sq % q_blk`` and
``Skv % kv_blk`` must be 0 after the clamps); the kernel
(``csrc/flash_attention.cu``) takes its own tiles of 32 queries and 64
keys, and any ``d`` up to 128.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.launcher import (F, I, P, Launcher, check_tensors,
                                          dtype_code)
from repro_torch.kernels.ref import NEG_INF

KERNEL = Launcher(symbol="launch_flash_attention",
                  argtypes=(P,) * 4 + (I,) * 7 + (F, I, P),
                  source="src/repro_torch/csrc/flash_attention.cu")
#: the kernel's kv tile: the plain version walks the same tiles
KV_TILE = 64
#: the widest head the kernel's registers and shared memory are laid out for
MAX_D = 128


def _check(q, k, v, q_blk, kv_blk) -> torch.device:
    dev = check_tensors("flash_attention", q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, H, Sq, d] and k, v "
                         f"[B, Hkv, Skv, d] expected; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, H, Sq, d = q.shape
    B2, Hkv, Skv, d2 = k.shape
    if B2 != B or d2 != d or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"serve q {tuple(q.shape)} (same B and d, H a "
                         f"multiple of Hkv)")
    q_blk, kv_blk = min(q_blk, Sq), min(kv_blk, Skv)
    if Sq % q_blk or Skv % kv_blk:
        raise ValueError(f"flash_attention: Sq {Sq} and Skv {Skv} are not "
                         f"whole tiles of {q_blk} and {kv_blk}")
    return dev


def flash_attention_plain(q, k, v, *, causal=True, q_blk=128, kv_blk=128):
    """The kernel's arithmetic in PyTorch: float32 throughout, the kv axis
    walked in the kernel's tiles of ``KV_TILE`` keys with the same online
    softmax (masked scores ``-1e30``, output ``acc / max(l, 1e-30)``).
    Tiles above every query's diagonal are skipped, as the kernel skips
    them tile by tile."""
    _check(q, k, v, q_blk, kv_blk)
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(B, Hkv, g, Sq, d).float()
    kf, vf = k.float(), v.float()
    m = torch.full((B, Hkv, g, Sq), NEG_INF, device=q.device)
    l = torch.zeros(B, Hkv, g, Sq, device=q.device)
    acc = torch.zeros(B, Hkv, g, Sq, d, device=q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kend = min(Skv, Sq) if causal else Skv
    for k0 in range(0, kend, KV_TILE):
        kt, vt = kf[:, :, k0:k0 + KV_TILE], vf[:, :, k0:k0 + KV_TILE]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale
        if causal:
            kpos = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                   vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, q_blk=128, kv_blk=128):
    """q: [B, H, Sq, d]; k, v: [B, Hkv, Skv, d] with H % Hkv == 0.
    Launches the kernel for tensors on the card (``d`` up to 128); runs
    :func:`flash_attention_plain` for tensors on the CPU."""
    dev = _check(q, k, v, q_blk, kv_blk)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_blk=q_blk,
                                     kv_blk=kv_blk)
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if d > MAX_D:
        raise ValueError(f"flash_attention: head width {d} exceeds the "
                         f"kernel's {MAX_D}")
    out = torch.empty_like(q)
    if out.numel():
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B, H, Hkv, Sq, Skv, d, int(causal), 1.0 / math.sqrt(d),
               dtype_code("flash_attention", q), device=dev)
    return out
