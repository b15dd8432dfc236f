"""qwen2-0.5b [dense] 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 - GQA, QKV bias [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True)
