"""granite-3-2b [dense] 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 - GQA [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", num_layers=40, d_model=2048,
    num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=49155)
