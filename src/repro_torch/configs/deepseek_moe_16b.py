"""deepseek-moe-16b [moe] 28L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=102400, MoE 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=102400,
    moe=MoECfg(num_experts=64, top_k=6, expert_d_ff=1408,
               num_shared=2, shared_d_ff=1408))
