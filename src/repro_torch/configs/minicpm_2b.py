"""minicpm-2b [dense] 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753 - WSD schedule (arch=llama-like) [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", num_layers=40, d_model=2304,
    num_heads=36, num_kv_heads=36, d_ff=5760, vocab_size=122753,
    schedule="wsd", tie_embeddings=True)
