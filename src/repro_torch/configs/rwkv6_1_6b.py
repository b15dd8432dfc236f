"""rwkv6-1.6b [ssm] 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
- Finch, data-dependent decay [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, RWKVCfg

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", num_layers=24, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=7168, vocab_size=65536,
    rwkv=RWKVCfg(head_dim=64, decay_lora=64, chunk=128))
