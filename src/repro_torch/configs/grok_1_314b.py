"""grok-1-314b [moe] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2 [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", num_layers=64, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=32768, vocab_size=131072,
    moe=MoECfg(num_experts=8, top_k=2, expert_d_ff=32768),
    opt_state_dtype="bfloat16")
