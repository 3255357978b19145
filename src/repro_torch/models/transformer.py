"""Model assembly, as ``repro.models.transformer``, for the ``dense``
family (training and serving) and the ``ssm`` family (attention-free
Mamba2, serving):

  init_params(cfg, generator=, device=)       → DenseLM | Mamba2LM
  model_from_arrays(cfg, arrays, device=)     → the same, from the
                                                reference's parameter tree
  param_leaves(cfg, model)                    → the reference's leaves
  forward_hidden(cfg, model, batch, remat=)   → (hidden, aux loss)
  loss_fn(cfg, model, batch, remat=)          → (loss, {"xent", "aux"})
  forward(cfg, model, batch)                  → fp32 logits (B, S, V), aux
  prefill(cfg, model, batch)                  → (last-position logits, cache)
  decode_step(cfg, model, token, cache, pos)  → (logits (B, V), cache)

The reference's stacked layer parameters under ``lax.scan`` become an
``nn.ModuleList`` of blocks walked by a Python loop, one
``nn.Parameter`` per layer tensor; :func:`param_leaves` groups them back
into the reference's leaves (the 32 layers' ``wq`` are one leaf), in the
reference's flatten order, for the optimizer and the checkpoint.

Training (``dense``): parameters require grad, weights are cast to the
activation dtype through autograd at each use, and with ``remat`` each
layer runs under ``torch.utils.checkpoint`` as the reference's ``_rscan``
wraps its body in ``jax.checkpoint``; attention is ``chunked_attention``.
Serving (``dense`` and ``ssm``): the entry points run under
``torch.inference_mode`` and cast weights through the cached
``L.cast_param``.  Dense prefill runs each layer's attention through the
``flash_attention`` kernel and returns the stacked KV cache (L, B, Hkv,
S, dh); dense decode writes each new token's k and v into that cache in
place.  Training ``ssm`` needs a backward of the ``ssd_scan`` kernel,
which no package has yet.  Other families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.models import attention as ATT
from repro_torch.models import io as IO
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.io import act_dtype

AUX_WEIGHT = 0.01  # MoE load-balance loss weight (0 · aux for dense)
PORTED_FAMILIES = ("dense", "ssm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported: ROADMAP Queue 1 "
            "step 5b (the other LM families)")


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
        _require_ported(cfg)
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2LM builds the ssm family, not "
                             f"{cfg.family!r}")

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


def _weight(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class MLPParams(nn.Module):
    """The SwiGLU weights ``w1``, ``w3`` (d, d_ff) and ``w2`` (d_ff, d)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = _weight(d, f, device=device)
        self.w3 = _weight(d, f, device=device)
        self.w2 = _weight(f, d, device=device)


class DenseBlock(nn.Module):
    """One pre-norm GQA decoder layer: ``ln1``, ``attn.{wq,wk,wv,wo}``,
    ``ln2``, ``mlp.{w1,w3,w2}`` (the reference's ``_init_dense_layer``
    tree).  Every parameter requires grad."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.attn = ATT.AttnParams(cfg, device=device)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.mlp = MLPParams(cfg, device=device)


class DenseLM(nn.Module):
    """Embedding table, ``layers`` (an ``nn.ModuleList`` of
    :class:`DenseBlock`), final norm and, when untied, ``lm_head``; every
    parameter requires grad."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        if cfg.family != "dense":
            raise ValueError(f"DenseLM builds the dense family, not "
                             f"{cfg.family!r}")
        self.embed = _weight(cfg.vocab_size, cfg.d_model, device=device)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model,
                                                  device=device))
        if not cfg.tie_embeddings:
            self.lm_head = _weight(cfg.vocab_size, cfg.d_model,
                                   device=device)
        self.layers = nn.ModuleList(DenseBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))


def _empty_model(cfg: ModelConfig, device) -> nn.Module:
    _require_ported(cfg)
    return (DenseLM if cfg.family == "dense" else Mamba2LM)(
        cfg, device=device)


@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> nn.Module:
    """A model with the reference's initial distributions (embed and
    lm_head N(0, 0.02²), norms 1, dense weights N(0, fan_in⁻¹), mixers
    per ``init_ssm_params``), drawn from ``generator``, which lies on
    ``device``."""
    model = _empty_model(cfg, device)
    model.embed.normal_(0.0, 0.02, generator=generator)
    if not cfg.tie_embeddings:
        model.lm_head.normal_(0.0, 0.02, generator=generator)
    for blk in model.layers:
        if cfg.family == "ssm":
            SSM.init_ssm_params(blk.ssm, generator=generator)
            continue
        ATT.init_attn_params(blk.attn, generator=generator)
        for name in ("w1", "w3", "w2"):
            w = getattr(blk.mlp, name)
            w.copy_(L.init_dense(tuple(w.shape), generator=generator,
                                 device=w.device))
    return model


def _flat_tree(tree: dict, prefix=()) -> dict:
    """Nested dict → {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@torch.no_grad()
def model_from_arrays(cfg: ModelConfig, arrays: dict, *, device
                      ) -> nn.Module:
    """A model holding the reference's parameter tree ``arrays`` (numpy,
    e.g. ``tree_map(np.asarray, T.init_params(cfg, key))``), whose layer
    leaves are stacked on a leading axis of ``num_layers``.  Every leaf is
    copied as it is; a missing, extra or misshapen leaf raises."""
    model = _empty_model(cfg, device)

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
    layers = _flat_tree(arrays["layers"])
    want = {tuple(n.split(".")) for n, _ in
            model.layers[0].named_parameters()}
    if set(layers) != want:
        raise KeyError(f"layer tree has {sorted(layers)}, the model wants "
                       f"{sorted(want)}")
    for li, blk in enumerate(model.layers):
        for name, param in blk.named_parameters():
            put(param, layers[tuple(name.split("."))][li],
                f"layers.{name}[{li}]")
    return model


class Leaf(NamedTuple):
    """One leaf of the reference's parameter tree, in the port.

    ``path`` holds the reference's dict keys (``("layers", "attn",
    "wq")``); ``tensors`` the port parameters that make it up: one, or one
    per layer when ``stacked`` (the reference stacks them on axis 0)."""

    path: tuple
    tensors: list
    stacked: bool


def param_leaves(cfg: ModelConfig, model: nn.Module) -> list[Leaf]:
    """The reference's parameter leaves in its ``tree_flatten`` order
    (dict keys sorted at every level): for stablelm-3b the 12 leaves
    embed, final_norm, layers/attn/{wk,wo,wq,wv}, layers/{ln1,ln2},
    layers/mlp/{w1,w2,w3}, lm_head."""
    _require_ported(cfg)
    leaves = [Leaf((name,), [p], False)
              for name, p in model.named_parameters(recurse=False)]
    per_layer = [dict(blk.named_parameters()) for blk in model.layers]
    for name in per_layer[0]:
        leaves.append(Leaf(("layers",) + tuple(name.split(".")),
                           [lp[name] for lp in per_layer], True))
    return sorted(leaves, key=lambda leaf: leaf.path)


def lm_head_table(cfg: ModelConfig, model: nn.Module) -> torch.Tensor:
    return model.embed if cfg.tie_embeddings else model.lm_head


def _logits(cfg: ModelConfig, model: nn.Module, x: torch.Tensor):
    name = "embed" if cfg.tie_embeddings else "lm_head"
    return L.logits(x, L.cast_param(model, name, x.dtype))


def _tokens(tokens, model: nn.Module) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=model.embed.device, dtype=torch.long)


def _dense_block(p: DenseBlock, h: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    a, _ = ATT.attention_layer(p.attn, L.rms_norm(h, p.ln1, cfg.norm_eps),
                               positions, cfg)
    h = h + a
    return h + L.swiglu(L.rms_norm(h, p.ln2, cfg.norm_eps), p.mlp.w1,
                        p.mlp.w3, p.mlp.w2)


def _ssm_block(p: SSMBlock, h: torch.Tensor, cfg: ModelConfig):
    return h + SSM.ssm_layer(p.ssm, L.rms_norm(h, p.ln1, cfg.norm_eps), cfg)


#: SSD layer that also returns its decode cache entry (the reference's name).
_ssm_prefill_layer = SSM.ssm_prefill


@torch.inference_mode()
def _ssm_forward_hidden(cfg: ModelConfig, model: Mamba2LM, batch: dict):
    x = L.embed(_tokens(batch["tokens"], model), model.embed, act_dtype(cfg))
    for blk in model.layers:
        x = _ssm_block(blk, x, cfg)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_hidden(cfg: ModelConfig, model: nn.Module, batch: dict, *,
                   remat: bool = False):
    """Full-sequence forward up to the final norm → (hidden, aux loss).

    ``dense``: differentiable; with ``remat`` (and grad enabled) each
    layer is checkpointed, so backward keeps one (B, S, d) input per layer
    and recomputes the rest.  ``ssm``: under ``torch.inference_mode``."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return _ssm_forward_hidden(cfg, model, batch)
    tokens = _tokens(batch["tokens"], model)
    B, S = tokens.shape
    x = L.embed(tokens, model.embed, act_dtype(cfg))
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    ckpt = remat and torch.is_grad_enabled()
    for blk in model.layers:
        if ckpt:
            x = checkpoint(_dense_block, blk, x, positions, cfg,
                           use_reentrant=False)
        else:
            x = _dense_block(blk, x, positions, cfg)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def fused_logits_xent(x: torch.Tensor, table: torch.Tensor,
                      labels: torch.Tensor, *, z_loss: float = 0.0) -> torch.Tensor:
    """Final projection + mean cross-entropy, the reference's single-device
    branch (``mesh is None``): fp32 logits of the activation-dtype
    operands, then logsumexp."""
    return L.cross_entropy(L.logits(x, table), labels, z_loss=z_loss)


def loss_fn(cfg: ModelConfig, model: nn.Module, batch: dict, *,
            remat: bool = False):
    """Training loss → (loss, {"xent": loss, "aux": aux}), differentiable
    with respect to every parameter of a ``dense`` model."""
    _require_ported(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family!r} family needs a backward of the "
            "ssd_scan kernel, which is not written yet (ROADMAP Queue 1)")
    x, aux = forward_hidden(cfg, model, batch, remat=remat)
    loss = fused_logits_xent(x, lm_head_table(cfg, model),
                             _tokens(batch["labels"], model))
    return loss + AUX_WEIGHT * aux, {"xent": loss, "aux": aux}


@torch.inference_mode()
def forward(cfg: ModelConfig, model: nn.Module, batch: dict):
    """Full-sequence forward → fp32 logits (B, S, V) and aux loss."""
    x, aux = forward_hidden(cfg, model, batch)
    return _logits(cfg, model, x), aux


def _serve_mlp(p: DenseBlock, h: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """The SwiGLU MLP of a served dense layer, weights cast through the
    cached :func:`L.cast_param`."""
    w = (L.cast_param(p.mlp, n, h.dtype) for n in ("w1", "w3", "w2"))
    return L.swiglu(L.rms_norm(h, p.ln2, cfg.norm_eps), *w)


def _dense_prefill(cfg: ModelConfig, model: DenseLM, x: torch.Tensor):
    """Dense layers over the prompt → (hidden, {"k", "v"}), each layer's
    k and v written into one stacked (L, B, Hkv, S, dh) buffer."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    spec = IO.cache_specs(cfg, ShapeConfig("prefill", "prefill", S, B))["k"]
    K = torch.empty(spec.shape, dtype=spec.dtype, device=x.device)
    V = torch.empty(spec.shape, dtype=spec.dtype, device=x.device)
    for li, blk in enumerate(model.layers):
        a, (k, v) = ATT.attention_prefill(
            blk.attn, L.rms_norm(x, blk.ln1, cfg.norm_eps), positions, cfg)
        K[li].copy_(k)
        V[li].copy_(v)
        x = x + a
        x = x + _serve_mlp(blk, x, cfg)
    return x, {"k": K, "v": V}


def _ssm_prefill(cfg: ModelConfig, model: Mamba2LM, x: torch.Tensor):
    convs, states = [], []
    for blk in model.layers:
        out, entry = _ssm_prefill_layer(
            blk.ssm, L.rms_norm(x, blk.ln1, cfg.norm_eps), cfg)
        x = x + out
        convs.append(entry["conv"])
        states.append(entry["ssm"])
    return x, {"conv": torch.stack(convs), "ssm": torch.stack(states)}


@torch.inference_mode()
def prefill(cfg: ModelConfig, model: nn.Module, batch: dict):
    """Returns (last-position fp32 logits (B, V), cache dict): ``{"k",
    "v"}`` (L, B, Hkv, S, dh) for ``dense``, ``{"conv", "ssm"}`` for
    ``ssm``."""
    _require_ported(cfg)
    x = L.embed(_tokens(batch["tokens"], model), model.embed, act_dtype(cfg))
    if cfg.family == "dense":
        x, cache = _dense_prefill(cfg, model, x)
    else:
        x, cache = _ssm_prefill(cfg, model, x)
    x = L.rms_norm(x[:, -1:, :], model.final_norm, cfg.norm_eps)
    return _logits(cfg, model, x)[:, 0, :], cache


@torch.inference_mode()
def decode_step(cfg: ModelConfig, model: nn.Module, token, cache: dict,
                pos=None):
    """token (B, 1) → (fp32 logits (B, V), cache).

    ``cache`` is updated in place, layer by layer, and returned: the
    reference returns a new cache, which here would copy the whole cache
    every token.  ``dense`` writes the token's k and v at ``pos`` (the
    count of valid positions, a host int) of each layer's slice of the
    stacked cache and attends to [0, pos]; ``ssm`` does not read ``pos``.
    """
    _require_ported(cfg)
    if cfg.family == "dense" and pos is None:
        raise ValueError("dense decode needs pos, the count of valid cache "
                         "positions")
    x = L.embed(_tokens(token, model), model.embed, act_dtype(cfg))
    for li, blk in enumerate(model.layers):
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        if cfg.family == "dense":
            a = ATT.attention_decode(blk.attn, h, cache["k"][li],
                                     cache["v"][li], pos, cfg)
            x = x + a
            x = x + _serve_mlp(blk, x, cfg)
            continue
        entry = {"conv": cache["conv"][li], "ssm": cache["ssm"][li]}
        out, new = SSM.ssm_decode(blk.ssm, h, entry, cfg)
        x = x + out
        cache["conv"][li].copy_(new["conv"])
        cache["ssm"][li].copy_(new["ssm"])
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(cfg, model, x)[:, 0, :], cache
