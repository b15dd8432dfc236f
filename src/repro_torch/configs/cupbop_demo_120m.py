"""The paper's own demo config: a ~120M LM whose hot paths run through the
CuPBoP-lowered kernels (examples/quickstart.py, examples/train_lm.py)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="cupbop-demo-120m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32768,
    tp_align=1, param_dtype="float32", compute_dtype="float32")
