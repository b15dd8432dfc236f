"""zamba2-7b [hybrid] 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64 - Mamba2 + shared attn block every 6 layers
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm=SSMCfg(state_dim=64, head_dim=64, expand=2, chunk=64),
    attn_every=6)
