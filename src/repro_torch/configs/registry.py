"""Registry for the 10 assigned architectures + the paper's demo config,
as ``repro/configs/registry.py``.

Definitions live in one module per arch (``configs/<id>.py``); this module
aggregates them for ``--arch <id>`` selection and provides reduced
``smoke()`` configs plus the assigned input-shape table.
"""
from __future__ import annotations

from repro_torch.configs import (
    cupbop_demo_120m, deepseek_moe_16b, granite_3_2b, grok_1_314b,
    internvl2_76b, minicpm_2b, musicgen_medium, qwen2_0_5b, qwen2_5_32b,
    rwkv6_1_6b, zamba2_7b,
)
from repro_torch.configs.base import ModelConfig, MoECfg, RWKVCfg, SSMCfg

_MODULES = [
    qwen2_5_32b, granite_3_2b, minicpm_2b, qwen2_0_5b, grok_1_314b,
    deepseek_moe_16b, internvl2_76b, zamba2_7b, rwkv6_1_6b, musicgen_medium,
    cupbop_demo_120m,
]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get(name)
    kw = dict(
        num_layers=2, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=max(1, min(4, cfg.num_kv_heads)),
        vocab_size=128, tp_align=1, vocab_align=8,
        param_dtype="float32", compute_dtype="float32", remat="none",
        q_chunk=16, kv_chunk=16, patch_prefix=8 if cfg.patch_prefix else 0,
    )
    if cfg.num_heads == cfg.num_kv_heads:   # MHA families stay MHA
        kw["num_kv_heads"] = 4
    if cfg.moe is not None:
        kw["moe"] = MoECfg(num_experts=4, top_k=2, expert_d_ff=32,
                           num_shared=cfg.moe.num_shared, shared_d_ff=32,
                           group_size=64)
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(state_dim=8, head_dim=16, expand=2, chunk=8)
        kw["num_layers"] = 4
        kw["attn_every"] = 2 if cfg.attn_every else 0
    if cfg.rwkv is not None:
        kw["rwkv"] = RWKVCfg(head_dim=16, decay_lora=8, chunk=8)
    return cfg.replace(name=cfg.name + "-smoke", **kw)


# Assigned input shapes (per arch; DESIGN.md S5 documents the skips)
SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288, global_batch=1),
}

SUBQUADRATIC = {"zamba2-7b", "rwkv6-1.6b"}


def cells():
    """All (arch, shape) dry-run cells, with documented long_500k skips."""
    out = []
    for a in ARCHS:
        if a == "cupbop-demo-120m":
            continue
        for s in SHAPES:
            if s == "long_500k" and a not in SUBQUADRATIC:
                continue  # quadratic full attention: documented skip
            out.append((a, s))
    return out
