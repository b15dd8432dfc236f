"""musicgen-medium [audio] 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 - decoder-only over EnCodec tokens; EnCodec frontend is a STUB
(4 codebooks, summed embeddings, 4 output heads) [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
    num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=2048,
    num_codebooks=4)
