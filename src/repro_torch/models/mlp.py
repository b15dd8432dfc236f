"""SwiGLU MLP block, as ``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import dense, silu, uniform_init


def init_mlp_params(gen: torch.Generator, d_model, d_ff, dtype):
    return {
        "w_gate": uniform_init(gen, (d_model, d_ff), 1.0, dtype),
        "w_up": uniform_init(gen, (d_model, d_ff), 1.0, dtype),
        "w_down": uniform_init(gen, (d_ff, d_model), 1.0, dtype),
    }


def mlp_block(cfg: ModelConfig, p, x):
    h = silu(dense(x, p["w_gate"], compute_dtype=cfg.cdtype)) * dense(
        x, p["w_up"], compute_dtype=cfg.cdtype)
    h = constrain(h, "batch", "seq", "tp")
    y = dense(h, p["w_down"], compute_dtype=cfg.cdtype)
    return constrain(y, "batch", "seq", None)
