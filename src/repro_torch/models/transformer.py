"""Model assembly, as ``repro.models.transformer``, for the ``dense``
family (training and serving) and the ``ssm`` (attention-free Mamba2),
``hybrid`` (Zamba2) and ``moe`` families (serving):

  init_params(cfg, generator=, device=)       → DenseLM | Mamba2LM |
                                                HybridLM | MoeLM
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
Serving (every family): the entry points run under
``torch.inference_mode`` and cast weights through the cached
``L.cast_param``.  Prefill runs each attention through the
``flash_attention`` kernel and each SSD layer through ``ssd_scan``;
decode writes each new token's k and v into the cache in place.

* ``hybrid`` (Zamba2): Mamba2 layers and **one** shared attention + MLP
  block (``shared``, a :class:`DenseBlock`), applied with the same
  weights after each group of ``attn_every`` layers; the layers past the
  last whole group have none after them.  Each application has its own
  KV cache (``attn_k`` / ``attn_v``, one per group).
* ``moe``: blocks of attention and a token-choice top-k MoE FFN
  (:mod:`repro_torch.models.moe`); ``forward_hidden`` returns the sum of
  the layers' aux losses, and the stacked KV cache is the dense one.

Training ``ssm`` and ``hybrid`` needs a backward of the ``ssd_scan``
kernel, which no package has yet; training ``moe`` is not ported yet.
``vlm`` and ``encdec`` raise ``NotImplementedError``.
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
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.io import act_dtype

AUX_WEIGHT = 0.01  # MoE load-balance loss weight
PORTED_FAMILIES = ("dense", "ssm", "hybrid", "moe")
#: Families whose decode attends to a KV cache (and so needs ``pos``).
ATTENTION_FAMILIES = ("dense", "hybrid", "moe")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported: ROADMAP Queue 1 "
            "step 5b (the vlm and encdec families)")


def _ones(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=torch.float32, device=device),
                        requires_grad=False)


class SSMBlock(nn.Module):
    """One pre-norm Mamba2 layer: ``ln1`` and the mixer ``ssm``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = _ones(cfg.d_model, device)
        self.ssm = SSM.SSMMixer(cfg, device=device)


def _tables(model: nn.Module, cfg: ModelConfig, device,
            requires_grad: bool) -> None:
    """The embedding table, the final norm and, when untied, ``lm_head``."""
    def param(t):
        return nn.Parameter(t, requires_grad=requires_grad)
    shape = (cfg.vocab_size, cfg.d_model)
    model.embed = param(torch.zeros(shape, dtype=torch.float32,
                                    device=device))
    model.final_norm = param(torch.ones(cfg.d_model, dtype=torch.float32,
                                        device=device))
    if not cfg.tie_embeddings:
        model.lm_head = param(torch.zeros(shape, dtype=torch.float32,
                                          device=device))


class Mamba2LM(nn.Module):
    """Embedding table, ``layers`` (an ``nn.ModuleList`` of
    :class:`SSMBlock`), final norm and, when untied, ``lm_head``."""

    family = "ssm"

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        _require_ported(cfg)
        if cfg.family != self.family:
            raise ValueError(f"{type(self).__name__} builds the "
                             f"{self.family} family, not {cfg.family!r}")
        _tables(self, cfg, device, requires_grad=False)
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
        _tables(self, cfg, device, requires_grad=True)
        self.layers = nn.ModuleList(DenseBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))


class HybridLM(Mamba2LM):
    """A :class:`Mamba2LM` plus ``shared``: the one :class:`DenseBlock`
    applied after each group of ``attn_every`` layers (the reference's
    ``params["shared"]``).  Serving only: no parameter requires grad."""

    family = "hybrid"

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__(cfg, device=device)
        self.shared = DenseBlock(cfg, device=device).requires_grad_(False)


class MoEBlock(nn.Module):
    """One pre-norm MoE decoder layer: ``ln1``, ``attn.{wq,wk,wv,wo}``,
    ``ln2``, ``moe.{router,w1,w3,w2}`` (the reference's
    ``_init_moe_layer`` tree)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = _ones(cfg.d_model, device)
        self.attn = ATT.AttnParams(cfg, device=device)
        self.ln2 = _ones(cfg.d_model, device)
        self.moe = MOE.MoEParams(cfg, device=device)


class MoeLM(nn.Module):
    """Embedding table, ``layers`` (an ``nn.ModuleList`` of
    :class:`MoEBlock`), final norm and, when untied, ``lm_head``.
    Serving only: no parameter requires grad."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        if cfg.family != "moe":
            raise ValueError(f"MoeLM builds the moe family, not "
                             f"{cfg.family!r}")
        _tables(self, cfg, device, requires_grad=False)
        self.layers = nn.ModuleList(MoEBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.requires_grad_(False)


_MODELS = {"dense": DenseLM, "ssm": Mamba2LM, "hybrid": HybridLM,
           "moe": MoeLM}


def _empty_model(cfg: ModelConfig, device) -> nn.Module:
    _require_ported(cfg)
    return _MODELS[cfg.family](cfg, device=device)


@torch.no_grad()
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> nn.Module:
    """A model with the reference's initial distributions (embed and
    lm_head N(0, 0.02²), norms 1, dense weights N(0, fan_in⁻¹), mixers
    per ``init_ssm_params``, MoE weights per ``init_moe_params``), drawn
    from ``generator``, which lies on ``device``."""
    model = _empty_model(cfg, device)
    model.embed.normal_(0.0, 0.02, generator=generator)
    if not cfg.tie_embeddings:
        model.lm_head.normal_(0.0, 0.02, generator=generator)
    blocks = list(model.layers)
    if cfg.family == "hybrid":
        blocks.append(model.shared)
    for blk in blocks:
        if isinstance(blk, SSMBlock):
            SSM.init_ssm_params(blk.ssm, generator=generator)
            continue
        ATT.init_attn_params(blk.attn, generator=generator)
        if isinstance(blk, MoEBlock):
            MOE.init_moe_params(blk.moe, generator=generator)
            continue
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
    leaves are stacked on a leading axis of ``num_layers`` (the hybrid's
    ``shared`` block is not stacked).  Every leaf is copied as it is; a
    missing, extra or misshapen leaf raises."""
    model = _empty_model(cfg, device)

    def put(param: nn.Parameter, value, name: str) -> None:
        value = np.asarray(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {value.shape}, model wants "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))

    def subtree(name: str, block: nn.Module) -> dict:
        tree = _flat_tree(arrays[name])
        want = {tuple(n.split(".")) for n, _ in block.named_parameters()}
        if set(tree) != want:
            raise KeyError(f"{name} tree has {sorted(tree)}, the model "
                           f"wants {sorted(want)}")
        return tree

    top = {"embed", "final_norm", "layers"} | (
        set() if cfg.tie_embeddings else {"lm_head"}) | (
        {"shared"} if cfg.family == "hybrid" else set())
    if set(arrays) != top:
        raise KeyError(f"parameter tree has {sorted(arrays)}, the model "
                       f"wants {sorted(top)}")
    for name in top - {"layers", "shared"}:
        put(getattr(model, name), arrays[name], name)
    if cfg.family == "hybrid":
        shared = subtree("shared", model.shared)
        for name, param in model.shared.named_parameters():
            put(param, shared[tuple(name.split("."))], f"shared.{name}")
    layers = subtree("layers", model.layers[0])
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
    layers/mlp/{w1,w2,w3}, lm_head; the hybrid's ``shared`` block gives
    one unstacked leaf per tensor, after ``layers``."""
    _require_ported(cfg)
    leaves = [Leaf((name,), [p], False)
              for name, p in model.named_parameters(recurse=False)]
    if cfg.family == "hybrid":
        leaves += [Leaf(("shared",) + tuple(name.split(".")), [p], False)
                   for name, p in model.shared.named_parameters()]
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


def _moe_block(p: MoEBlock, h: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig):
    a, _ = ATT.attention_layer(p.attn, L.rms_norm(h, p.ln1, cfg.norm_eps),
                               positions, cfg)
    h = h + a
    y, aux = MOE.moe_layer(p.moe, L.rms_norm(h, p.ln2, cfg.norm_eps), cfg)
    return h + y, aux


def _ssm_block(p: SSMBlock, h: torch.Tensor, cfg: ModelConfig):
    return h + SSM.ssm_layer(p.ssm, L.rms_norm(h, p.ln1, cfg.norm_eps), cfg)


def _shared_group(cfg: ModelConfig, li: int):
    """The hybrid's group whose shared block follows layer ``li`` (the
    index of its KV cache), or None: the block follows every
    ``attn_every``-th layer, none follows the layers past the last whole
    group (the reference's ``_hybrid_split``)."""
    if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
        return li // cfg.attn_every
    return None


#: SSD layer that also returns its decode cache entry (the reference's name).
_ssm_prefill_layer = SSM.ssm_prefill


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


@torch.inference_mode()
def _served_forward_hidden(cfg: ModelConfig, model: nn.Module, batch: dict):
    """``forward_hidden`` of the families served only (ssm, hybrid,
    moe)."""
    tokens = _tokens(batch["tokens"], model)
    B, S = tokens.shape
    x = L.embed(tokens, model.embed, act_dtype(cfg))
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, blk in enumerate(model.layers):
        if cfg.family == "moe":
            x, a = _moe_block(blk, x, positions, cfg)
            aux = aux + a
            continue
        x = _ssm_block(blk, x, cfg)
        if _shared_group(cfg, li) is not None:
            x = _dense_block(model.shared, x, positions, cfg)
    return L.rms_norm(x, model.final_norm, cfg.norm_eps), aux


def forward_hidden(cfg: ModelConfig, model: nn.Module, batch: dict, *,
                   remat: bool = False):
    """Full-sequence forward up to the final norm → (hidden, aux loss;
    the sum of the layers' for ``moe``, else 0).

    ``dense``: differentiable; with ``remat`` (and grad enabled) each
    layer is checkpointed, so backward keeps one (B, S, d) input per layer
    and recomputes the rest.  The other families: under
    ``torch.inference_mode``."""
    _require_ported(cfg)
    if cfg.family != "dense":
        return _served_forward_hidden(cfg, model, batch)
    tokens = _tokens(batch["tokens"], model)
    B, S = tokens.shape
    x = L.embed(tokens, model.embed, act_dtype(cfg))
    positions = _positions(B, S, tokens.device)
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
    if cfg.family == "moe":
        raise NotImplementedError(
            "training the 'moe' family is not yet ported (ROADMAP Queue 1 "
            "step 4c)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family!r} family needs a backward of the "
            "ssd_scan kernel, which is not written yet (ROADMAP Queue 1 "
            "step 4b)")
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


def _serve_ffn(p: DenseBlock | MoEBlock, h: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """h plus the served block's FFN: the SwiGLU MLP or the MoE layer."""
    if isinstance(p, MoEBlock):
        y, _ = MOE.moe_layer(p.moe, L.rms_norm(h, p.ln2, cfg.norm_eps), cfg)
        return h + y
    return h + _serve_mlp(p, h, cfg)


def _block_prefill(cfg: ModelConfig, p: DenseBlock | MoEBlock,
                   x: torch.Tensor, positions: torch.Tensor,
                   K: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """One attention block over the prompt, its k and v written into the
    cache slices K, V (B, Hkv, S, dh)."""
    a, (k, v) = ATT.attention_prefill(
        p.attn, L.rms_norm(x, p.ln1, cfg.norm_eps), positions, cfg)
    K.copy_(k)
    V.copy_(v)
    return _serve_ffn(p, x + a, cfg)


def _block_decode(cfg: ModelConfig, p: DenseBlock | MoEBlock,
                  x: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                  pos: int) -> torch.Tensor:
    """One attention block on one token, its k and v written at ``pos``
    of the cache slices K, V in place."""
    a = ATT.attention_decode(p.attn, L.rms_norm(x, p.ln1, cfg.norm_eps), K,
                             V, pos, cfg)
    return _serve_ffn(p, x + a, cfg)


def _kv_cache(cfg: ModelConfig, x: torch.Tensor) -> dict:
    """Uninitialised KV buffers of the prefill, as ``cache_specs`` at the
    prompt's length."""
    B, S, _ = x.shape
    specs = IO.cache_specs(cfg, ShapeConfig("prefill", "prefill", S, B))
    return {n: torch.empty(s.shape, dtype=s.dtype, device=x.device)
            for n, s in specs.items() if n in ("k", "v", "attn_k", "attn_v")}


def _attention_prefill(cfg: ModelConfig, model: nn.Module, x: torch.Tensor):
    """Dense or MoE layers over the prompt → (hidden, {"k", "v"}), each
    layer's k and v written into one stacked (L, B, Hkv, S, dh) buffer."""
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    cache = _kv_cache(cfg, x)
    for li, blk in enumerate(model.layers):
        x = _block_prefill(cfg, blk, x, positions, cache["k"][li],
                           cache["v"][li])
    return x, cache


def _ssm_prefill(cfg: ModelConfig, model: Mamba2LM, x: torch.Tensor):
    """Mamba2 layers over the prompt → (hidden, {"conv", "ssm"}); for the
    hybrid also the shared block after each group, its k and v written
    into ``attn_k`` / ``attn_v`` (n_groups, B, Hkv, S, dh)."""
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    cache = _kv_cache(cfg, x)
    convs, states = [], []
    for li, blk in enumerate(model.layers):
        out, entry = _ssm_prefill_layer(
            blk.ssm, L.rms_norm(x, blk.ln1, cfg.norm_eps), cfg)
        x = x + out
        convs.append(entry["conv"])
        states.append(entry["ssm"])
        g = _shared_group(cfg, li)
        if g is not None:
            x = _block_prefill(cfg, model.shared, x, positions,
                               cache["attn_k"][g], cache["attn_v"][g])
    cache.update(conv=torch.stack(convs), ssm=torch.stack(states))
    return x, cache


@torch.inference_mode()
def prefill(cfg: ModelConfig, model: nn.Module, batch: dict):
    """Returns (last-position fp32 logits (B, V), cache dict): ``{"k",
    "v"}`` (L, B, Hkv, S, dh) for ``dense`` and ``moe``, ``{"conv",
    "ssm"}`` for ``ssm``, and those two plus ``{"attn_k", "attn_v"}``
    (n_groups, B, Hkv, S, dh) for ``hybrid``."""
    _require_ported(cfg)
    x = L.embed(_tokens(batch["tokens"], model), model.embed, act_dtype(cfg))
    if cfg.family in ("dense", "moe"):
        x, cache = _attention_prefill(cfg, model, x)
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
    every token.  ``dense``, ``moe`` and ``hybrid`` write the token's k
    and v at ``pos`` (the count of valid positions, a host int) of each
    attention's slice of the cache and attend to [0, pos]; ``ssm`` does
    not read ``pos``.
    """
    _require_ported(cfg)
    if cfg.family in ATTENTION_FAMILIES and pos is None:
        raise ValueError(f"{cfg.family} decode needs pos, the count of "
                         "valid cache positions")
    x = L.embed(_tokens(token, model), model.embed, act_dtype(cfg))
    for li, blk in enumerate(model.layers):
        if cfg.family in ("dense", "moe"):
            x = _block_decode(cfg, blk, x, cache["k"][li], cache["v"][li],
                              pos)
            continue
        entry = {"conv": cache["conv"][li], "ssm": cache["ssm"][li]}
        out, new = SSM.ssm_decode(
            blk.ssm, L.rms_norm(x, blk.ln1, cfg.norm_eps), entry, cfg)
        x = x + out
        cache["conv"][li].copy_(new["conv"])
        cache["ssm"][li].copy_(new["ssm"])
        g = _shared_group(cfg, li)
        if g is not None:
            x = _block_decode(cfg, model.shared, x, cache["attn_k"][g],
                              cache["attn_v"][g], pos)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return _logits(cfg, model, x)[:, 0, :], cache
