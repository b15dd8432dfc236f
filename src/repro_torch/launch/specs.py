"""Input, cache and optimizer placements and meta-tensor stand-ins for the
dry run, as ``repro/launch/specs.py``.

``input_specs(cfg, shape_name)`` returns meta tensors (shape and dtype,
nothing allocated) for every model input of an (arch x shape) cell.  The
VLM / audio modality frontends are stubs, as the reference's: patch and
frame embeddings arrive as precomputed inputs.  Where the reference
returns ``NamedSharding``s, these return DTensor placements (one a mesh
dim), resolved by ``distributed.sharding``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import SHAPES
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import param_placements
from repro_torch.models import transformer as T

_META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, shape_name: str):
    """Batch meta tensors for a cell.  For decode cells this is the
    (cache, tokens) pair of ``decode_step`` - one new token against a
    KV / state cache of seq_len."""
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    tok = torch.int32
    if kind in ("train", "prefill"):
        if cfg.num_codebooks > 1:
            return {"tokens": _meta((B, S, cfg.num_codebooks), tok)}
        if cfg.patch_prefix:
            return {"tokens": _meta((B, S - cfg.patch_prefix), tok),
                    "patch_embeds": _meta((B, cfg.patch_prefix, cfg.d_model),
                                          cfg.cdtype)}
        return {"tokens": _meta((B, S), tok)}
    # decode: cache of seq_len + one token
    cache = T.init_cache(cfg, B, S, device=_META)
    tshape = (B, 1, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, 1)
    return {"cache": cache, "tokens": _meta(tshape, tok)}


_CACHE_LOGICAL = shd.CACHE_LOGICAL


def cache_sharding(cache_struct, mesh):
    """Each cache leaf's placements (``pos``, a host int, has none)."""
    return {k: shd.cache_placements(mesh, k, v.shape)
            for k, v in cache_struct.items() if isinstance(v, torch.Tensor)}


def batch_sharding(batch_struct, mesh):
    """Each batch leaf's placements: dim 0 ``"batch"``, the rest whole."""
    return {k: shd.batch_placements(mesh, v.shape)
            for k, v in batch_struct.items()}


def train_shardings(cfg: ModelConfig, mesh, batch_struct):
    """(params, opt_state, param placements, opt placements, batch
    placements) for ``train_step``: the trees on meta."""
    from repro_torch.optim import adamw
    pstruct = T.abstract_params(cfg)
    pspec = param_placements(pstruct, mesh)
    ostruct = adamw.init_state(
        adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype), pstruct)
    whole = shd.placements(mesh, shd.P())
    ospec = adamw.AdamWState(step=whole,
                             m=param_placements(ostruct.m, mesh),
                             v=param_placements(ostruct.v, mesh))
    return pstruct, ostruct, pspec, ospec, batch_sharding(batch_struct, mesh)
