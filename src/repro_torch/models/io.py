"""Decode-cache specifications per (arch × shape), as ``repro.models.io``
(``cache_specs`` / ``zero_cache``), for every family."""
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
    """Specs of the decode cache at ``seq_len`` capacity: for ``dense``,
    ``moe`` and ``vlm`` the stacked per-layer keys and values (L, B, Hkv,
    seq_len, dh) in the activation dtype; for ``encdec`` the decoder's
    ``self_k`` / ``self_v`` and the encoder's ``cross_k`` / ``cross_v``,
    each of that shape (the reference sizes the cross cache by seq_len
    too: its stub frontend emits one frame per position); for ``ssm`` the
    stacked conv window and SSD state (neither grows with seq_len); for
    ``hybrid`` the ssm pair of every layer plus ``attn_k`` / ``attn_v``
    (n_groups, B, Hkv, seq_len, dh), one per application of the shared
    block, n_groups = L // attn_every.  Another family raises
    ``ValueError``."""
    B, Lr = shape.global_batch, cfg.num_layers
    dt = act_dtype(cfg)
    att = (B, cfg.num_kv_heads, shape.seq_len, cfg.head_dim)
    kv = TensorSpec((Lr,) + att, dt)
    if cfg.family in ("dense", "moe", "vlm"):
        return {"k": kv, "v": kv}
    if cfg.family == "encdec":
        return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv}
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"unknown model family {cfg.family!r}")
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    specs = {
        "conv": TensorSpec((Lr, B, cfg.ssm_conv_width - 1, conv_ch), dt),
        "ssm": TensorSpec((Lr, B, cfg.ssm_nheads, cfg.ssm_state,
                           cfg.ssm_headdim), torch.float32),
    }
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // cfg.attn_every
        specs["attn_k"] = specs["attn_v"] = TensorSpec((n_groups,) + att, dt)
    return specs


def zero_cache(cfg: ModelConfig, shape: ShapeConfig, *, device) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_specs(cfg, shape).items()}
