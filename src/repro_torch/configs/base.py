"""Model/config system, as ``repro/configs/base.py``.

A ``ModelConfig`` is a frozen dataclass, so it hashes and compares by its
fields.  The 10 assigned architectures are in sibling modules;
``repro_torch.configs.registry`` resolves ``--arch`` names.  Configs
describe shapes only: no weights are loaded or fetched.  ``pdtype`` and
``cdtype`` are torch dtypes named by the same strings as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared: int = 0          # deepseek-style always-on shared experts
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024       # tokens per dispatch group (memory bound)
    dispatch: str = "einsum"     # "einsum" (GShard one-hot, baseline) or
                                 # "sort" (gather/scatter, optimization O3)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 64          # N
    head_dim: int = 64           # P
    expand: int = 2
    chunk: int = 128
    conv_dim: int = 4
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rwkv: Optional[RWKVCfg] = None
    attn_every: int = 0          # zamba2: shared attn block applied every k layers
    num_codebooks: int = 1       # musicgen
    patch_prefix: int = 0        # internvl2: # of precomputed patch embeddings
    tie_embeddings: bool = False
    # numerics / scale policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # bf16 for >=30B models (DESIGN.md S6)
    remat: str = "full"                 # none | dots | full
    schedule: str = "cosine"            # minicpm: "wsd"
    # TP alignment (heads/vocab padded to multiples; 1 disables = smoke cfgs)
    tp_align: int = 16
    vocab_align: int = 128
    # attention chunking for the XLA flash path
    q_chunk: int = 512
    kv_chunk: int = 1024
    # beyond-paper optimization switches (EXPERIMENTS.md §Perf)
    causal_skip: bool = False    # skip fully-masked KV chunks in flash scan
    seq_shard_long: bool = False # shard long-context KV cache over 'data'
    seq_parallel: bool = False   # Megatron-SP: residual stream seq-sharded
                                 # over 'model' between layers
    bf16_tiles: bool = False     # flash prob tiles in bf16 (halve HBM bytes)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        a = self.vocab_align
        return math.ceil(self.vocab_size / a) * a

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter count (for 6ND model flops; padding excluded - it is overhead)
    def param_count(self, active_only: bool = False) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, Hq, Hkv = self.hd, self.num_heads, self.num_kv_heads
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V
        if self.rwkv is not None:
            per = 4 * D * D + D * F + F * D + D * self.rwkv.decay_lora * 2
            return n + L * per
        attn = D * (Hq + 2 * Hkv) * hd + Hq * hd * D
        per = attn
        if self.moe is not None:
            e = self.moe.top_k if active_only else self.moe.num_experts
            per = attn + 3 * e * D * self.moe.expert_d_ff + D * self.moe.num_experts
            if self.moe.num_shared:
                per += 3 * D * self.moe.shared_d_ff
        elif self.ssm is not None:
            d_in = self.ssm.expand * D
            H = d_in // self.ssm.head_dim
            per = 2 * D * d_in + d_in * D + D * (2 * self.ssm.ngroups *
                                                 self.ssm.state_dim + H)
            if self.attn_every:
                n += attn  # zamba2 shared attention block: one param set total
        else:
            per += 3 * D * F
        return int(n + L * per)
