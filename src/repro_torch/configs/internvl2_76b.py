"""internvl2-76b [vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 - InternViT + InternLM2; vision frontend is a STUB
(input_specs supplies 1024 precomputed patch embeddings)
[arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    patch_prefix=1024, opt_state_dtype="bfloat16")
