"""Decode-cache specifications per (arch × shape), as ``repro.models.io``
(``cache_specs`` / ``zero_cache``) for the ``dense`` and ``ssm``
families; the other families raise ``NotImplementedError`` until they
are ported."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.config.base import ModelConfig, ShapeConfig


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache tensor (``jax.ShapeDtypeStruct``'s
    counterpart)."""

    shape: tuple
    dtype: torch.dtype


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Specs of the decode cache at ``seq_len`` capacity: for ``dense``
    the stacked per-layer keys and values (L, B, Hkv, seq_len, dh) in the
    activation dtype; for ``ssm`` the stacked conv window and SSD state
    (neither grows with seq_len)."""
    B, Lr = shape.global_batch, cfg.num_layers
    if cfg.family == "dense":
        kv = TensorSpec((Lr, B, cfg.num_kv_heads, shape.seq_len,
                         cfg.head_dim), act_dtype(cfg))
        return {"k": kv, "v": kv}
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"the decode cache of family {cfg.family!r} is not yet ported: "
            "ROADMAP Queue 1 step 5b (the other families)")
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": TensorSpec((Lr, B, cfg.ssm_conv_width - 1, conv_ch),
                           act_dtype(cfg)),
        "ssm": TensorSpec((Lr, B, cfg.ssm_nheads, cfg.ssm_state,
                           cfg.ssm_headdim), torch.float32),
    }


def zero_cache(cfg: ModelConfig, shape: ShapeConfig, *, device) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_specs(cfg, shape).items()}
