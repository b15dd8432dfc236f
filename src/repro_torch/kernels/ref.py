"""Torch oracles for the hot-path kernels, as ``repro/kernels/ref.py``."""
from __future__ import annotations

import torch

#: the reference's mask value: finite, so a masked score minus a finite
#: running max never makes a NaN
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, with_lse=False):
    """Exact softmax attention.  q [B,H,Sq,d]; k/v [B,Hkv,Skv,d] (GQA by
    h // g).  The causal mask is top-left: ``qpos >= kpos``, both counted
    from 0, whatever ``Sq`` and ``Skv`` are.  ``with_lse`` returns
    ``(out, lse)``, the rows' float32 logsumexp ``[B, H, Sq]``."""
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) / torch.sqrt(
        torch.tensor(d, dtype=torch.float32))
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        mask = qpos >= torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    o = o.reshape(B, H, Sq, d).to(q.dtype)
    if with_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def rmsnorm_ref(x, scale, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def matmul_ref(a, b):
    return torch.matmul(a.float(), b.float()).to(a.dtype)
