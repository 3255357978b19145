"""Model assembly, as ``repro.models.transformer``, for the ``ssm`` family
(attention-free Mamba2):

  init_params(cfg, generator=, device=)       → Mamba2LM
  model_from_arrays(cfg, arrays, device=)     → Mamba2LM
  forward(cfg, model, batch)                  → fp32 logits (B, S, V), aux
  prefill(cfg, model, batch)                  → (last-position logits, cache)
  decode_step(cfg, model, token, cache, pos)  → (logits (B, V), cache)

The reference's stacked layer parameters under ``lax.scan`` become an
``nn.ModuleList`` of :class:`SSMBlock` walked by a Python loop; the
decode cache keeps the reference's stacked layout ({"conv": (L, B, K−1,
C), "ssm": (L, B, H, N, P)}).  Serving has no backward: the entry points
run under ``torch.inference_mode``.  Other families raise
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.io import act_dtype


def _require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported: ROADMAP Queue 1 "
            "step 5 (the other LM families)")


def _ones(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=torch.float32, device=device),
                        requires_grad=False)


class SSMBlock(nn.Module):
    """One pre-norm Mamba2 layer: ``ln1`` and the mixer ``ssm``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = _ones(cfg.d_model, device)
        self.ssm = SSM.SSMMixer(cfg, device=device)


class Mamba2LM(nn.Module):
    """Embedding table, ``layers`` (an ``nn.ModuleList`` of
    :class:`SSMBlock`), final norm and, when untied, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        _require_ssm(cfg)

        def table():
            return nn.Parameter(torch.zeros(
                (cfg.vocab_size, cfg.d_model), dtype=torch.float32,
                device=device), requires_grad=False)
        self.embed = table()
        self.final_norm = _ones(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = table()
        self.layers = nn.ModuleList(SSMBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))


@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> Mamba2LM:
    """A model with the reference's initial distributions (embed and
    lm_head N(0, 0.02²), norms 1, mixers per ``init_ssm_params``), drawn
    from ``generator``, which lies on ``device``."""
    model = Mamba2LM(cfg, device=device)
    model.embed.normal_(0.0, 0.02, generator=generator)
    if not cfg.tie_embeddings:
        model.lm_head.normal_(0.0, 0.02, generator=generator)
    for blk in model.layers:
        SSM.init_ssm_params(blk.ssm, generator=generator)
    return model


@torch.no_grad()
def model_from_arrays(cfg: ModelConfig, arrays: dict, *, device
                      ) -> Mamba2LM:
    """A model holding the reference's parameter tree ``arrays`` (numpy,
    e.g. ``tree_map(np.asarray, T.init_params(cfg, key))``), whose layer
    leaves are stacked on a leading axis of ``num_layers``.  Every leaf is
    copied as it is; a missing, extra or misshapen leaf raises."""
    model = Mamba2LM(cfg, device=device)

    def put(param: nn.Parameter, value, name: str) -> None:
        value = np.asarray(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {value.shape}, model wants "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))

    top = {"embed", "final_norm", "layers"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(arrays) != top:
        raise KeyError(f"parameter tree has {sorted(arrays)}, the model "
                       f"wants {sorted(top)}")
    for name in top - {"layers"}:
        put(getattr(model, name), arrays[name], name)
    layers = arrays["layers"]
    mixer_names = dict(model.layers[0].ssm.named_parameters())
    if set(layers) != {"ln1", "ssm"} or set(layers["ssm"]) != set(
            mixer_names):
        raise KeyError(f"layer tree has {sorted(layers)} / "
                       f"{sorted(layers.get('ssm', {}))}")
    for li, blk in enumerate(model.layers):
        put(blk.ln1, layers["ln1"][li], f"layers.ln1[{li}]")
        for name, param in blk.ssm.named_parameters():
            put(param, layers["ssm"][name][li], f"layers.ssm.{name}[{li}]")
    return model


def lm_head_table(cfg: ModelConfig, model: Mamba2LM) -> torch.Tensor:
    return model.embed if cfg.tie_embeddings else model.lm_head


def _logits(cfg: ModelConfig, model: Mamba2LM, x: torch.Tensor):
    name = "embed" if cfg.tie_embeddings else "lm_head"
    return L.logits(x, L.cast_param(model, name, x.dtype))


def _tokens(tokens, model: Mamba2LM) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=model.embed.device, dtype=torch.long)


def _ssm_block(p: SSMBlock, h: torch.Tensor, cfg: ModelConfig):
    return h + SSM.ssm_layer(p.ssm, L.rms_norm(h, p.ln1, cfg.norm_eps), cfg)


#: SSD layer that also returns its decode cache entry (the reference's name).
_ssm_prefill_layer = SSM.ssm_prefill


@torch.inference_mode()
def forward_hidden(cfg: ModelConfig, model: Mamba2LM, batch: dict):
    """Full-sequence forward up to the final norm → (hidden, aux loss)."""
    _require_ssm(cfg)
    x = L.embed(_tokens(batch["tokens"], model), model.embed, act_dtype(cfg))
    for blk in model.layers:
        x = _ssm_block(blk, x, cfg)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.inference_mode()
def forward(cfg: ModelConfig, model: Mamba2LM, batch: dict):
    """Full-sequence forward → fp32 logits (B, S, V) and aux loss."""
    x, aux = forward_hidden(cfg, model, batch)
    return _logits(cfg, model, x), aux


@torch.inference_mode()
def prefill(cfg: ModelConfig, model: Mamba2LM, batch: dict):
    """Returns (last-position fp32 logits (B, V), cache dict)."""
    _require_ssm(cfg)
    x = L.embed(_tokens(batch["tokens"], model), model.embed, act_dtype(cfg))
    convs, states = [], []
    for blk in model.layers:
        out, entry = _ssm_prefill_layer(
            blk.ssm, L.rms_norm(x, blk.ln1, cfg.norm_eps), cfg)
        x = x + out
        convs.append(entry["conv"])
        states.append(entry["ssm"])
    cache = {"conv": torch.stack(convs), "ssm": torch.stack(states)}
    x = L.rms_norm(x[:, -1:, :], model.final_norm, cfg.norm_eps)
    return _logits(cfg, model, x)[:, 0, :], cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, model: Mamba2LM, token, cache: dict,
                pos=None):
    """token (B, 1) → (fp32 logits (B, V), cache).

    ``cache`` is updated in place, layer by layer, and returned: the
    reference returns a new cache, which here would copy the (L, B, H,
    N, P) state every token.  ``pos`` (the count of valid positions) is
    not read by the ``ssm`` family.
    """
    _require_ssm(cfg)
    x = L.embed(_tokens(token, model), model.embed, act_dtype(cfg))
    for li, blk in enumerate(model.layers):
        entry = {"conv": cache["conv"][li], "ssm": cache["ssm"][li]}
        out, new = SSM.ssm_decode(
            blk.ssm, L.rms_norm(x, blk.ln1, cfg.norm_eps), entry, cfg)
        x = x + out
        cache["conv"][li].copy_(new["conv"])
        cache["ssm"][li].copy_(new["ssm"])
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(cfg, model, x)[:, 0, :], cache
